"""Cases, inputs and rank bodies of the sharded-LM tests
(``tests/test_torch_lm_sharded.py``).  Torch and numpy only: spawned
gloo ranks import this module by name, and the reference's side (a
subprocess on forced host devices, ``REF_CODE``) imports it for the
cases and the inputs.

Every input is drawn here from numpy seeds, leaf by leaf with a seed of
the leaf's path, so that both packages' trees (the port's
``convert._lm_shapes``, the reference's ``jax.eval_shape`` of its init)
get the same numbers whatever their traversal order.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

SEED = 0
BATCH = 4                 # rows: the data axis of 2 splits them
DECODE_STEPS = 3
LR, WARMUP, TOTAL = 1e-3, 1, 10     # one AdamW step at lr 1e-3
MESHES = ((1, 2), (2, 1), (2, 2))
# name -> (arch, config overrides, prompt length, max_len).  Mixtral's
# window is 16 in the reduced config: a prompt past it must be a
# multiple of 16; its ring wraps while decoding.
CASES = {
    "stablelm": ("stablelm-12b", {}, 12, 24),
    "qwen": ("qwen1.5-32b", {}, 12, 24),
    "dbrx": ("dbrx-132b", {}, 12, 24),
    "mixtral": ("mixtral-8x7b", {}, 32, 48),
    # tight capacity: entries drop, and the drops follow the mesh's
    # dispatch groups (the data axis's size)
    "mixtral_cf": ("mixtral-8x7b", {"capacity_factor": 0.5}, 32, 48),
}
TRAIN_SEQ = 16


def config(case: str, get):
    """The reduced config of ``case`` from ``get`` (either package's
    ``configs.get``)."""
    arch, over, _, _ = CASES[case]
    return dataclasses.replace(get(arch).reduced(), **over)


def draw(shapes, seed: int = SEED, prefix: str = ""):
    """A numpy tree of ``shapes`` (nested dicts and lists, shape tuples
    as leaves): each leaf drawn from a seed of its path, norm scales
    near one, Qwen's zero-initialised ``bq``/``bk``/``bv`` random too
    (a zero bias would hide its sharding), weights at 1/sqrt(fan in)."""
    if isinstance(shapes, dict):
        return {k: draw(v, seed, f"{prefix}{k}/") for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [draw(v, seed, f"{prefix}{i}/") for i, v in enumerate(shapes)]
    path = prefix[:-1]
    rng = np.random.RandomState((zlib.crc32(path.encode()) + seed) % 2 ** 31)
    x = rng.randn(*shapes).astype(np.float32)
    if path.endswith("scale"):
        return (1 + 0.1 * x).astype(np.float32)
    if path.endswith("embed"):
        return (0.02 * x).astype(np.float32)
    fan_in = shapes[-2] if len(shapes) >= 2 else 10
    return (x / np.sqrt(fan_in)).astype(np.float32)


def tokens(cfg, rows: int, length: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(rows, length)).astype(np.int32)


def inputs(case: str, cfg) -> dict:
    """The prompts and the training batch of ``case``."""
    _, _, s, _ = CASES[case]
    return {"prompt": tokens(cfg, BATCH, s, 1),
            "inputs": tokens(cfg, BATCH, TRAIN_SEQ, 2),
            "targets": tokens(cfg, BATCH, TRAIN_SEQ, 3)}


# ---------------------------------------------------------------------------
# The port's side: one call runs every case of one mesh (or none).
# ---------------------------------------------------------------------------

def run_case(case: str, mesh=None) -> dict:
    """Prefill, ``DECODE_STEPS`` greedy decode steps, the loss and its
    grads, and one train step of ``case`` on the port: sharded under a
    live ``mesh`` (every result gathered whole), else in one process
    (under a layout-only context when ``mesh`` is one)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.convert import _lm_shapes, lm_params_from_numpy
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step,
                                          make_train_step, value_and_grad)
    from repro_torch.models.lm import build_lm
    from repro_torch.optim import adamw_init

    cfg = config(case, get)
    _, _, _, max_len = CASES[case]
    lm = build_lm(cfg, device="cpu")
    full = lm_params_from_numpy(draw(_lm_shapes(cfg)), cfg, "cpu")
    data = {k: torch.from_numpy(v) for k, v in inputs(case, cfg).items()}
    live = mesh is not None and mesh.live
    out = {}

    def serve_ctx():
        return SH.mesh_context(mesh, fsdp=cfg.fsdp_serve)

    def train_ctx():
        return SH.mesh_context(mesh, fsdp=cfg.fsdp_train)

    def whole(t, spec):
        return SH.gather_block(t, spec, mesh) if live else t

    with torch.no_grad(), serve_ctx() as mc:
        params = (SH.place(full, SH.param_specs(full, mc), mesh) if live
                  else full)
        # the rank's logits: its rows where the data axis splits them,
        # its vocab columns
        lspec = SH.constrain((BATCH,), "batch") + (None, "model")
        prefill, decode = make_prefill_step(lm), make_decode_step(lm)
        cache = lm.init_cache(BATCH, max_len)
        logits, cache = prefill(params, {"inputs": data["prompt"]}, cache)
        out["prefill_logits"] = whole(logits, lspec)
        toks = torch.argmax(out["prefill_logits"], -1).to(torch.int32)
        steps_t, steps_l = [toks], []
        for _ in range(DECODE_STEPS):
            toks, logits, cache = decode(params, {"inputs": toks}, cache)
            steps_t.append(toks)
            steps_l.append(whole(logits, lspec))
        out["decode_tokens"] = torch.cat(steps_t, 1)
        out["decode_logits"] = torch.cat(steps_l, 1)

    batch = {"inputs": data["inputs"], "targets": data["targets"]}
    with train_ctx() as mc:
        specs = SH.param_specs(full, mc) if live else None
        params = SH.place(full, specs, mesh) if live else full
        loss, grads = value_and_grad(lm, params, batch)
        out["loss"] = loss
        out["grads"] = SH.gather(grads, specs, mesh) if live else grads
        step = make_train_step(lm, base_lr=LR, warmup=WARMUP, total=TOTAL)
        opt = adamw_init(params)
        new, opt, metrics = step(params, opt, batch)
        out["new_params"] = SH.gather(new, specs, mesh) if live else new
        out["gnorm"] = metrics["gnorm"]
        out["step_loss"] = metrics["loss"]
    return out


def flat(tree, prefix: str = "") -> dict:
    """``{path: numpy array}`` of a tree of dicts and lists (torch
    tensors, jax or numpy arrays, numbers as leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
        return out
    if hasattr(tree, "detach"):
        tree = tree.detach().float().numpy()
    return {prefix[:-1]: np.asarray(tree)}


def rank_main(rank: int, world: int, dp: int, mp: int, ckpt: str) -> dict:
    """One gloo rank of a ``dp x mp`` mesh on the CPU: every case
    (:func:`run_case`, flattened), the collectives it issued, its param
    and cache bytes beside the blocks its specs give, a 2,064-token
    prefill's K5 calls (through the wrapper's CPU oracle) with their q /
    kv head counts, ``serve`` on the mesh, and the elastic checkpoint of
    the reduced DBRX: saved from dp2 x mp2 into ``ckpt``, restored
    from it onto dp1 x mp2 (each block bit for bit)."""
    import torch

    import repro_torch.models.layers as L
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get
    from repro_torch.convert import _lm_shapes, lm_params_from_numpy
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import abstract_params
    from repro_torch.models.lm import build_lm

    torch.set_num_threads(1)
    mesh = make_dev_mesh(dp, mp, backend="gloo", device="cpu")
    out = {}
    for case in CASES:
        before = dict(mesh.counts)
        out.update({f"{case}/{k}": v for k, v in flat(run_case(case, mesh))
                    .items()})
        out[f"{case}/collectives"] = {k: n - before.get(k, 0)
                                      for k, n in mesh.counts.items()}
    # bytes: the blocks held against the specs' blocks of the full trees
    cfg = config("dbrx", get)
    lm = build_lm(cfg, device="cpu")
    full = lm_params_from_numpy(draw(_lm_shapes(cfg)), cfg, "cpu")
    with SH.mesh_context(mesh, fsdp=cfg.fsdp_serve) as mc:
        specs = SH.param_specs(full, mc)
        params = SH.place(full, specs, mesh)
        cache = lm.init_cache(BATCH, 24)
        _, meta = abstract_params(cfg)
        with SH.mesh_context(None):        # the whole cache's shapes
            meta_cache = build_lm(cfg, device="meta").init_cache(BATCH, 24)

        def nbytes(tree):
            return sum(t.numel() * t.element_size()
                       for t in flat_tensors(tree))

        def spec_bytes(tree, specs_):
            return sum(int(np.prod(SH.local_shape(t.shape, s, mesh)))
                       * t.element_size()
                       for t, s in zip(flat_tensors(tree),
                                       flat_specs(tree, specs_)))
        out["bytes"] = {
            "params": nbytes(params),
            "params_specs": spec_bytes(meta, SH.param_specs(meta, mc)),
            "cache": nbytes(cache),
            "cache_specs": spec_bytes(meta_cache,
                                      SH.cache_specs(meta_cache, mc))}
        if (dp, mp) == (2, 2):
            CheckpointManager(ckpt).save(0, params, blocking=True,
                                         mesh=mesh, specs=specs)
        elif (dp, mp) == (1, 2):
            _, got = CheckpointManager(ckpt).restore(
                meta, shardings=(mesh, specs))
            out["restore_equal"] = all(
                torch.equal(a, b) for a, b in zip(flat_tensors(got),
                                                 flat_tensors(params)))
    # K5 on the rank's heads: a prefill past 2,048 tokens
    cfg = config("stablelm", get)
    lm = build_lm(cfg, device="cpu")
    full = lm_params_from_numpy(draw(_lm_shapes(cfg)), cfg, "cpu")
    calls = []
    real = L.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)
    L.flash_attention = counted
    try:
        with torch.no_grad(), SH.mesh_context(mesh) as mc:
            params = SH.place(full, SH.param_specs(full, mc), mesh)
            cache = lm.init_cache(2, 2080)
            prompt = torch.from_numpy(tokens(cfg, 2, 2064, 4))
            logits, _ = lm.prefill(params, {"inputs": prompt}, cache)
            spec = SH.constrain((2,), "batch") + (None, "model")
            out["k5_logits"] = SH.gather_block(logits, spec, mesh).numpy()
            out["k5_calls"] = calls
            res, _ = serve(cfg, tokens(cfg, 3, 6, 5).tolist(), max_new=4,
                           slots=4, max_len=16, params=params,
                           device="cpu")
            out["serve"] = [res[i] for i in range(3)]
    finally:
        L.flash_attention = real
    return out if rank == 0 else {"bytes": out["bytes"],
                                  "k5_calls": out["k5_calls"]}


def flat_tensors(tree):
    """The tensors of a tree (dicts in key order, lists, NamedTuples)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flat_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in flat_tensors(v)]
    return [tree] if hasattr(tree, "numel") else []


def flat_specs(tree, specs):
    """The specs of :func:`flat_tensors`' tensors, in their order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in flat_specs(tree[k],
                                                           specs[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v, u in zip(tree, specs) for s in flat_specs(v, u)]
    return [specs] if hasattr(tree, "numel") else []


# ---------------------------------------------------------------------------
# The reference's side: jitted with its shardings under mesh_context on
# forced host devices (run as ``python -c REF_CODE.format(...)``, one
# process per mesh: the jit compiles dominate).
# ---------------------------------------------------------------------------

REF_CODE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
import _torch_lm_shard as H
from repro.configs import get
from repro.distributed.sharding import (MeshContext, batch_shardings,
                                        cache_shardings, mesh_context,
                                        param_shardings)
from repro.launch.mesh import make_dev_mesh
from repro.launch.steps import (make_decode_step, make_prefill_step,
                                make_train_step)
from repro.models.lm import build_lm
from repro.optim import adamw_init


def shapes(t):
    if isinstance(t, dict):
        return {{k: shapes(v) for k, v in t.items()}}
    if isinstance(t, (list, tuple)):
        return [shapes(v) for v in t]
    return tuple(t.shape)


out = {{}}
for dp, mp in {meshes!r}:
    mesh = make_dev_mesh(dp, mp)
    for case in H.CASES:
        cfg = H.config(case, get)
        lm = build_lm(cfg)
        params = jax.tree.map(jnp.asarray, H.draw(shapes(
            jax.eval_shape(lm.init, jax.random.PRNGKey(0)))))
        data = H.inputs(case, cfg)
        max_len = H.CASES[case][3]
        mc = MeshContext(mesh, strategy=cfg.mesh_strategy,
                         fsdp=cfg.fsdp_serve)
        ps = param_shardings(params, mc)
        batch = {{"inputs": jnp.asarray(data["prompt"])}}
        cache = lm.init_cache(H.BATCH, max_len)
        cs = cache_shardings(cache, mc)
        mct = MeshContext(mesh, strategy=cfg.mesh_strategy,
                          fsdp=cfg.fsdp_train)
        pst = param_shardings(params, mct)
        tb = {{"inputs": jnp.asarray(data["inputs"]),
              "targets": jnp.asarray(data["targets"])}}
        opt = adamw_init(params)
        mco = MeshContext(mesh, strategy=cfg.mesh_strategy, fsdp=True)
        osh = type(opt)(NamedSharding(mesh, P()),
                        param_shardings(opt.mu, mco),
                        param_shardings(opt.nu, mco),
                        param_shardings(opt.master, mco)
                        if opt.master is not None else None)
        step = make_train_step(lm, base_lr=H.LR, warmup=H.WARMUP,
                               total=H.TOTAL)

        def both(p, o, b):
            loss, g = jax.value_and_grad(lm.loss)(p, b)
            p2, _, m = step(p, o, b)
            return loss, g, p2, m["gnorm"], m["loss"]
        with mesh_context(mesh):
            pf = jax.jit(make_prefill_step(lm),
                         in_shardings=(ps, batch_shardings(batch, mc), cs),
                         out_shardings=(None, cs))
            logits, cache = pf(params, batch, cache)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            dec = jax.jit(make_decode_step(lm), in_shardings=(
                ps, batch_shardings({{"inputs": tok}}, mc), cs),
                out_shardings=(None, None, cs))
            toks, lgs = [tok], []
            for _ in range(H.DECODE_STEPS):
                tok, lg, cache = dec(params, {{"inputs": tok}}, cache)
                toks.append(tok)
                lgs.append(lg)
            f = jax.jit(both, in_shardings=(pst, osh,
                                            batch_shardings(tb, mct)))
            loss, grads, new, gnorm, sl = f(params, opt, tb)
        res = {{"prefill_logits": logits,
               "decode_tokens": jnp.concatenate(toks, 1),
               "decode_logits": jnp.concatenate(lgs, 1),
               "loss": loss, "grads": grads, "new_params": new,
               "gnorm": gnorm, "step_loss": sl}}
        for k, v in H.flat(jax.tree.map(np.asarray, res)).items():
            out[f"{{dp}}x{{mp}}/{{case}}/{{k}}"] = v
np.savez({path!r}, **out)
print("REF_OK", len(out))
"""


def blocked_worker(rank: int, world: int) -> dict:
    """A dp2 x mp2 rank with ``jax`` and ``repro`` unimportable: the
    sharded DBRX case, the full DBRX's specs from the meta device, and
    the modules it loaded checked for either."""
    import sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import torch

    from repro_torch.configs import SHAPES, get
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.steps import abstract_params, input_specs

    torch.set_num_threads(1)
    mesh = make_dev_mesh(2, 2, backend="gloo", device="cpu")
    out = run_case("dbrx", mesh)
    _, meta = abstract_params(get("dbrx-132b"))
    specs = SH.param_specs(meta, SH.MeshContext(mesh))
    bspecs = SH.batch_specs(input_specs(get("dbrx-132b"),
                                        SHAPES["train_4k"]),
                            SH.MeshContext(mesh))
    bad = sorted(m for m in sys.modules
                 if (m == "jax" or m.startswith("jax.") or m == "repro"
                     or m.startswith("repro.")) and sys.modules[m] is not None)
    return {"loss": float(out["loss"]), "bad": bad,
            "embed": specs["embed"], "inputs": bspecs["inputs"]}
