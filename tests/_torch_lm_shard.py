"""Cases, inputs and rank bodies of the sharded-LM tests
(``tests/test_torch_lm_sharded.py``: the attention decoders, ``CASES``;
``tests/test_torch_lm_sharded_recurrent.py``: the recurrent slots and
the frontends, ``RECURRENT``).  Torch and numpy only: spawned gloo ranks
import this module by name, and the reference's side (a subprocess on
forced host devices, ``REF_CODE``) imports it for the cases and the
inputs.

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
# The recurrent slots and the frontends: Jamba (Mamba + attention + MoE,
# moe_ep, fsdp_serve), xLSTM (mLSTM + sLSTM), InternVL2 (8 patches ahead
# of the text) and Whisper (32 frames, its decoder capped at 64).  The
# prompts are no multiple of the reduced chunks (8): both scans pad.
RECURRENT = {
    "jamba": ("jamba-1.5-large-398b", {}, 12, 24),
    "xlstm": ("xlstm-350m", {}, 12, 24),
    "internvl2": ("internvl2-76b", {}, 12, 24),
    "whisper": ("whisper-small", {}, 12, 24),
}
# A model axis that does not divide the heads, the kv heads or
# Whisper's encoder positions: they run replicated over it, as the
# reference's constrain degrades them.  name -> (arch, overrides,
# prompt, max_len); UNEVEN_MESH gives each its (dp, mp).  StableLM at 6
# heads on mp 4 (neither the q nor the kv heads divide), at 6 q / 3 kv
# heads on mp 2 (the q heads divide, the kv heads do not, and the
# rank's q heads read 1.5 kv heads: one kv head per q head), and as
# reduced on mp 4 (1 q head and half a kv head a rank, the layout of
# StableLM-2-12B at 16 ranks); Whisper's 30 encoder positions on mp 4;
# xLSTM's mLSTM at 2 heads on mp 4.
UNEVEN = {
    "stablelm_h6": ("stablelm-12b", {"n_heads": 6}, 12, 24),
    "stablelm_kv3": ("stablelm-12b", {"n_heads": 6, "n_kv_heads": 3}, 12,
                     24),
    "stablelm_mp4": ("stablelm-12b", {}, 12, 24),
    "whisper_enc30": ("whisper-small", {"enc_positions": 30}, 12, 24),
    "xlstm_h2": ("xlstm-350m", {"n_heads": 2, "n_kv_heads": 2}, 12, 24),
}
UNEVEN_MESH = {"stablelm_h6": (1, 4), "stablelm_kv3": (1, 2),
               "stablelm_mp4": (1, 4), "whisper_enc30": (1, 4),
               "xlstm_h2": (1, 4)}
TABLES = {"CASES": CASES, "RECURRENT": RECURRENT, "UNEVEN": UNEVEN}
TRAIN_SEQ = 16
LONG = 2064                # a prefill past 2,048 positions: K5's


def _entry(case: str):
    for table in TABLES.values():
        if case in table:
            return table[case]
    raise KeyError(case)


def config(case: str, get):
    """The reduced config of ``case`` from ``get`` (either package's
    ``configs.get``)."""
    arch, over, _, _ = _entry(case)
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


def embeds(cfg, rows: int, seed: int) -> dict:
    """The precomputed embeddings ``cfg`` reads beside its tokens (the
    patch frontend's, the encoder's frames), N(0, 1) from a seed."""
    rng = np.random.RandomState(seed)
    if cfg.frontend == "patch":
        return {"patch_embeds": rng.randn(rows, cfg.n_patches,
                                          cfg.frontend_dim).astype(np.float32)}
    if cfg.enc_dec:
        return {"frame_embeds": rng.randn(rows, cfg.enc_positions,
                                          cfg.d_model).astype(np.float32)}
    return {}


def inputs(case: str, cfg) -> dict:
    """The prompts and the training batch of ``case``, and the
    embeddings both read (``embeds``)."""
    _, _, s, _ = _entry(case)
    return {"prompt": tokens(cfg, BATCH, s, 1),
            "inputs": tokens(cfg, BATCH, TRAIN_SEQ, 2),
            "targets": tokens(cfg, BATCH, TRAIN_SEQ, 3),
            **embeds(cfg, BATCH, 6)}


def prefill_batch(data: dict) -> dict:
    """The prefill's batch of :func:`inputs`' arrays: the prompt and the
    embeddings."""
    return {"inputs": data["prompt"],
            **{k: v for k, v in data.items() if k.endswith("_embeds")}}


def train_batch(data: dict) -> dict:
    return {k: v for k, v in data.items() if k != "prompt"}


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
    _, _, _, max_len = _entry(case)
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
        logits, cache = prefill(params, prefill_batch(data), cache)
        out["prefill_logits"] = whole(logits, lspec)
        toks = torch.argmax(out["prefill_logits"], -1).to(torch.int32)
        steps_t, steps_l = [toks], []
        for _ in range(DECODE_STEPS):
            toks, logits, cache = decode(params, {"inputs": toks}, cache)
            steps_t.append(toks)
            steps_l.append(whole(logits, lspec))
        out["decode_tokens"] = torch.cat(steps_t, 1)
        out["decode_logits"] = torch.cat(steps_l, 1)

    batch = train_batch(data)
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


def recurrent_rank_main(rank: int, world: int, dp: int, mp: int) -> dict:
    """One gloo rank of a ``dp x mp`` mesh on the CPU for the
    ``RECURRENT`` cases: each case (:func:`run_case`, flattened) with the
    collectives it issued; per case the rank's param bytes and every
    cache leaf's bytes beside the specs' blocks, and its fresh cache
    against the blocks of the one-process cache (``m`` at -1e30); the
    collectives of a prefill of S and of 2 S prompt tokens; K5's calls
    (through the wrapper's CPU oracle) in a prefill past 2,048 positions
    of the reduced Jamba and InternVL2 with their logits; ``serve`` of
    the reduced xLSTM and Jamba on the mesh."""
    import torch

    import repro_torch.models.layers as L
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
    for case in RECURRENT:
        before = dict(mesh.counts)
        out.update({f"{case}/{k}": v for k, v in flat(run_case(case, mesh))
                    .items()})
        out[f"{case}/collectives"] = {k: n - before.get(k, 0)
                                      for k, n in mesh.counts.items()}
    calls = []
    real = L.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)
    for case in RECURRENT:
        cfg = config(case, get)
        _, _, s, max_len = RECURRENT[case]
        lm = build_lm(cfg, device="cpu")
        full = lm_params_from_numpy(draw(_lm_shapes(cfg)), cfg, "cpu")
        data = {k: torch.from_numpy(v) for k, v in inputs(case, cfg).items()}
        with torch.no_grad(), SH.mesh_context(mesh,
                                              fsdp=cfg.fsdp_serve) as mc:
            params = SH.place(full, SH.param_specs(full, mc), mesh)
            cache = lm.init_cache(BATCH, max_len)
            _, meta = abstract_params(cfg)
            with SH.mesh_context(None):
                whole = build_lm(cfg, device="cpu").init_cache(BATCH,
                                                               max_len)
            specs = SH.cache_specs(whole, mc)
            leaves = dict(SH._tree_paths(cache))
            want = dict(SH._tree_paths(SH.place(whole, specs, mesh)))
            out[f"{case}/bytes"] = {
                "params": sum(t.numel() * t.element_size()
                              for t in flat_tensors(params)),
                "params_specs": sum(
                    int(np.prod(SH.local_shape(t.shape, sp, mesh)))
                    * t.element_size()
                    for t, sp in zip(flat_tensors(meta),
                                     flat_specs(meta, SH.param_specs(meta,
                                                                     mc))))}
            out[f"{case}/cache"] = {
                path: (t.numel() * t.element_size(),
                       want[path].numel() * want[path].element_size(),
                       bool(torch.equal(t, want[path])))
                for path, t in leaves.items() if hasattr(t, "numel")}
            # the collectives of a prefill of S and of 2 S tokens
            counts = []
            for n in (s, 2 * s):
                batch = {k: v[:, :n] if k == "prompt" else v
                         for k, v in data.items()}
                batch["prompt"] = torch.from_numpy(
                    tokens(cfg, BATCH, n, 7))
                c = lm.init_cache(BATCH, 64)
                snap = dict(mesh.counts)
                lm.prefill(params, prefill_batch(batch), c)
                counts.append({k: v - snap.get(k, 0)
                               for k, v in mesh.counts.items()
                               if v != snap.get(k, 0)})
            out[f"{case}/prefill_counts"] = counts
            if case in ("jamba", "internvl2"):
                n = LONG - cfg.n_patches
                long = {"inputs": torch.from_numpy(tokens(cfg, 2, n, 4)),
                        **{k: torch.from_numpy(v)
                           for k, v in embeds(cfg, 2, 8).items()}}
                calls.clear()
                L.flash_attention = counted
                try:
                    logits, _ = lm.prefill(params, long,
                                           lm.init_cache(2, LONG + 16))
                finally:
                    L.flash_attention = real
                spec = SH.constrain((2,), "batch") + (None, "model")
                out[f"{case}/k5_logits"] = SH.gather_block(
                    logits, spec, mesh).numpy()
                out[f"{case}/k5_calls"] = list(calls)
            if case in ("jamba", "xlstm"):
                res, _ = serve(cfg, tokens(cfg, 3, 6, 5).tolist(),
                               max_new=4, slots=4, max_len=16,
                               params=params, device="cpu")
                out[f"{case}/serve"] = [res[i] for i in range(3)]
    if rank == 0:
        return out
    return {k: v for k, v in out.items()
            if k.split("/", 1)[1] in ("bytes", "cache", "prefill_counts",
                                      "k5_calls")}


def uneven_rank_main(rank: int, world: int, dp: int, mp: int) -> dict:
    """One gloo rank of a ``dp x mp`` mesh on the CPU for the ``UNEVEN``
    cases of that mesh: each case (:func:`run_case`, flattened) with the
    collectives it issued, and on mp 4 the K5 calls (through the
    wrapper's CPU oracle) of a 2,064-token prefill of the reduced
    StableLM, whose rank runs 1 q head against half a kv head's
    columns, with their q / kv head counts and the logits."""
    import torch

    import repro_torch.models.layers as L
    from repro_torch.configs import get
    from repro_torch.convert import _lm_shapes, lm_params_from_numpy
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models.lm import build_lm

    torch.set_num_threads(1)
    mesh = make_dev_mesh(dp, mp, backend="gloo", device="cpu")
    out = {}
    for case in UNEVEN:
        if UNEVEN_MESH[case] != (dp, mp):
            continue
        before = dict(mesh.counts)
        out.update({f"{case}/{k}": v for k, v in flat(run_case(case, mesh))
                    .items()})
        out[f"{case}/collectives"] = {k: n - before.get(k, 0)
                                      for k, n in mesh.counts.items()}
    if (dp, mp) == UNEVEN_MESH["stablelm_mp4"]:
        cfg = config("stablelm_mp4", get)
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
                logits, _ = lm.prefill(
                    params, {"inputs": torch.from_numpy(
                        tokens(cfg, 2, LONG, 4))}, lm.init_cache(2, LONG + 16))
                spec = SH.constrain((2,), "batch") + (None, "model")
                out["k5_logits"] = SH.gather_block(logits, spec,
                                                   mesh).numpy()
        finally:
            L.flash_attention = real
        out["k5_calls"] = calls
    if rank == 0:
        return out
    return {k: v for k, v in out.items() if k == "k5_calls"}


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
    for case in H.TABLES[{table!r}]:
        if H.UNEVEN_MESH.get(case, (dp, mp)) != (dp, mp):
            continue
        cfg = H.config(case, get)
        lm = build_lm(cfg)
        params = jax.tree.map(jnp.asarray, H.draw(shapes(
            jax.eval_shape(lm.init, jax.random.PRNGKey(0)))))
        data = H.inputs(case, cfg)
        max_len = H._entry(case)[3]
        mc = MeshContext(mesh, strategy=cfg.mesh_strategy,
                         fsdp=cfg.fsdp_serve)
        ps = param_shardings(params, mc)
        batch = {{k: jnp.asarray(v)
                  for k, v in H.prefill_batch(data).items()}}
        cache = lm.init_cache(H.BATCH, max_len)
        cs = cache_shardings(cache, mc)
        mct = MeshContext(mesh, strategy=cfg.mesh_strategy,
                          fsdp=cfg.fsdp_train)
        pst = param_shardings(params, mct)
        tb = {{k: jnp.asarray(v) for k, v in H.train_batch(data).items()}}
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
    sharded DBRX case, one prefill and one decode step of the sharded
    reduced Jamba (Mamba, attention and MoE slots), the full DBRX's specs
    from the meta device, and the modules it loaded checked for
    either."""
    import sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import torch

    from repro_torch.configs import SHAPES, get
    from repro_torch.convert import _lm_shapes, lm_params_from_numpy
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.steps import (abstract_params, input_specs,
                                          make_decode_step,
                                          make_prefill_step)
    from repro_torch.models.lm import build_lm

    torch.set_num_threads(1)
    mesh = make_dev_mesh(2, 2, backend="gloo", device="cpu")
    out = run_case("dbrx", mesh)
    cfg = config("jamba", get)
    lm = build_lm(cfg, device="cpu")
    full = lm_params_from_numpy(draw(_lm_shapes(cfg)), cfg, "cpu")
    with torch.no_grad(), SH.mesh_context(mesh, fsdp=cfg.fsdp_serve) as mc:
        params = SH.place(full, SH.param_specs(full, mc), mesh)
        cache = lm.init_cache(BATCH, 24)
        logits, cache = make_prefill_step(lm)(params, {
            "inputs": torch.from_numpy(tokens(cfg, BATCH, 12, 1))}, cache)
        tok = torch.argmax(SH.gather_block(
            logits, SH.constrain((BATCH,), "batch") + (None, "model"),
            mesh), -1).to(torch.int32)
        tok, logits, cache = make_decode_step(lm)(params, {"inputs": tok},
                                                  cache)
    _, meta = abstract_params(get("dbrx-132b"))
    specs = SH.param_specs(meta, SH.MeshContext(mesh))
    bspecs = SH.batch_specs(input_specs(get("dbrx-132b"),
                                        SHAPES["train_4k"]),
                            SH.MeshContext(mesh))
    bad = sorted(m for m in sys.modules
                 if (m == "jax" or m.startswith("jax.") or m == "repro"
                     or m.startswith("repro.")) and sys.modules[m] is not None)
    return {"loss": float(out["loss"]), "bad": bad,
            "embed": specs["embed"], "inputs": bspecs["inputs"],
            "jamba": tok[:, 0].tolist(),
            "jamba_finite": bool(torch.isfinite(logits).all())}


# ---------------------------------------------------------------------------
# The dry-run against live ranks (tests/test_torch_dryrun.py).
# ---------------------------------------------------------------------------

# (name, step, seq, batch): a train step, a prefill past 2,048 tokens
# (K5's) and a decode step, at the reduced StableLM's widths
DRY_CELLS = (("train", "train", 32, 4), ("prefill", "prefill", LONG, 2),
             ("decode", "decode", 64, 4))
DRY_MESHES = ((1, 2, 2), (1, 1, 4), (2, 1, 2))      # (pod, dp, mp)


def dry_cell(name: str):
    from repro_torch.configs import ShapeCell
    for n, step, seq, batch in DRY_CELLS:
        if n == name:
            return ShapeCell(n, step, seq, batch)
    raise KeyError(name)


def dryrun_rank_main(rank: int, world: int, pod: int, dp: int,
                     mp: int) -> dict:
    """One gloo rank of a ``pod x dp x mp`` mesh on the CPU: each
    ``DRY_CELLS`` step of the reduced StableLM on random inputs
    (``dryrun.live_inputs``), run once under ``dryrun.run_step``'s
    trace; per cell the collectives it issued (calls and traffic), the
    tensor-core FLOPs and the K5 calls."""
    import torch

    from repro_torch.configs import get
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_dev_mesh

    torch.set_num_threads(1)
    mesh = make_dev_mesh(dp, mp, n_pod=pod, backend="gloo", device="cpu")
    cfg = get("stablelm-12b").reduced()
    out = {}
    for name, *_ in DRY_CELLS:
        cell = dry_cell(name)
        mc = D.cell_context(cfg, cell, mesh)
        lm, args = D.live_inputs(cfg, cell, mesh, mc, "cpu", seed=rank)
        mesh.counts.clear()
        mesh.traffic.clear()
        _, tr, _ = D.run_step(lm, cfg, cell, mc, args)
        out[name] = {"counts": dict(mesh.counts),
                     "traffic": {k: dict(v) for k, v in mesh.traffic.items()},
                     "flops": tr.flops, "k5": tr.k5,
                     "k5_shapes": tr.k5_shapes}
    return out


# ---------------------------------------------------------------------------
# The sequence-parallel residual stream (tests/test_torch_seq_parallel.py).
# ---------------------------------------------------------------------------

# A dense decoder, MoE (moe_tp), Mamba <-> attention transitions with an
# MoE attention slot, and the patches ahead of the text (8 + 16 = 24
# positions); ``odd``: a 15-token batch, which the model axis of 2 does
# not divide, so the residual stream stays whole.
SEQ_CASES = ("stablelm", "mixtral", "jamba", "internvl2")
SEQ_ODD = ("stablelm", 15)
SEQ_ACTS = ("seq", "batch")
# (name, case, step, seq, batch) of the live steps the dry-run's trace is
# held against, at microbatch 1: Jamba's reaches every rule (Mamba and
# attention slots, an MoE attention slot)
SEQ_DRY = (("jamba", "jamba", "train", 16, 2),)


def seq_config(case: str, act: str, get):
    return dataclasses.replace(config(case, get), act_shard=act)


def dry_config(case: str, get):
    return dataclasses.replace(config(case, get), microbatch=1)


def ulp_draw(shapes, seed: int = SEED, prefix: str = ""):
    """:func:`draw`'s tree with every element moved by one f32 ulp up or
    down (signs from a seed of the leaf's path): the params of a
    case's spread."""
    tree = draw(shapes, seed, prefix)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(t)]
        rng = np.random.RandomState(sum(map(ord, path)) % 2 ** 31)
        step = np.float32(2.0 ** -23) * rng.choice([-1, 1], t.shape)
        return (t * (1 + step)).astype(np.float32)
    return walk(tree, prefix)


def train_case(case: str, act: str, mesh=None, length: int = TRAIN_SEQ,
               ulp: bool = False) -> dict:
    """The loss and its grads of ``case`` (reduced, ``act_shard=act``) on
    a ``length``-token batch, and one AdamW train step: sharded under a
    live ``mesh`` (grads and params gathered whole, and the collectives
    of the loss's grads), else in one process (under a layout-only
    context where ``mesh`` is one: the MoE's dispatch groups follow
    it).  ``ulp``: from :func:`ulp_draw`'s params."""
    import torch

    from repro_torch.configs import get
    from repro_torch.convert import _lm_shapes, lm_params_from_numpy
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models.lm import build_lm
    from repro_torch.optim import adamw_init

    cfg = seq_config(case, act, get)
    lm = build_lm(cfg, device="cpu")
    full = lm_params_from_numpy((ulp_draw if ulp else draw)(
        _lm_shapes(cfg)), cfg, "cpu")
    batch = {"inputs": tokens(cfg, BATCH, length, 2),
             "targets": tokens(cfg, BATCH, length, 3),
             **embeds(cfg, BATCH, 6)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    live = mesh is not None and mesh.live
    out = {}
    with SH.mesh_context(mesh, fsdp=cfg.fsdp_train) as mc:
        specs = SH.param_specs(full, mc) if live else None
        params = SH.place(full, specs, mesh) if live else full
        before = dict(mesh.counts) if live else {}
        loss, grads = value_and_grad(lm, params, batch)
        if live:
            out["collectives"] = {k: n - before.get(k, 0)
                                  for k, n in mesh.counts.items()
                                  if n != before.get(k, 0)}
        out["loss"] = loss
        out["grads"] = SH.gather(grads, specs, mesh) if live else grads
        step = make_train_step(lm, base_lr=LR, warmup=WARMUP, total=TOTAL)
        new, _, metrics = step(params, adamw_init(params), batch)
        out["new_params"] = SH.gather(new, specs, mesh) if live else new
        out["gnorm"] = metrics["gnorm"]
    return out


SEQ_MESHES = ((1, 2), (2, 2))


def seq_rank_main(rank: int, world: int) -> dict:
    """One of 4 gloo ranks on the CPU, on two meshes: dp2 x mp2, then
    (ranks 0 and 1) dp1 x mp2 over their pair, so that one spawn serves
    both.  On each mesh (``{(dp, mp): ...}``), :func:`seq_mesh_run`."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch.mesh import make_dev_mesh

    torch.set_num_threads(1)
    wide = make_dev_mesh(2, 2, backend="gloo", device="cpu")
    # every rank of the world makes the pair's group
    pair = dist.new_group([0, 1], backend="gloo",
                          timeout=datetime.timedelta(seconds=300))
    out = {(2, 2): seq_mesh_run(wide)}
    if rank < 2:
        out[(1, 2)] = seq_mesh_run(Mesh(1, 2, rank=rank, backend="gloo",
                                        device=torch.device("cpu"),
                                        groups={"model": pair}))
    return out


def seq_mesh_run(mesh) -> dict:
    """One rank's work on ``mesh``: every ``SEQ_CASES`` case under each
    ``SEQ_ACTS`` layout (:func:`train_case`, flattened, with the
    collectives of its loss's grads), the ``SEQ_ODD`` case under both,
    and each ``SEQ_DRY`` step on random inputs (``dryrun.live_inputs``)
    run once under ``dryrun.run_step``'s trace: its collectives and
    FLOPs.  The mesh's rank 0 returns everything, the others their
    tallies."""
    from repro_torch.configs import ShapeCell, get
    from repro_torch.launch import dryrun as D

    out = {}
    for case in SEQ_CASES:
        for act in SEQ_ACTS:
            res = train_case(case, act, mesh)
            out[f"{case}/{act}/collectives"] = res.pop("collectives")
            out.update({f"{case}/{act}/{k}": v
                        for k, v in flat(res).items()})
    case, length = SEQ_ODD
    for act in SEQ_ACTS:
        res = train_case(case, act, mesh, length)
        out[f"odd/{act}/collectives"] = res.pop("collectives")
        out.update({f"odd/{act}/{k}": v for k, v in flat(res).items()})
    for name, case, step, seq, rows in SEQ_DRY:
        cfg = dry_config(case, get)
        cell = ShapeCell(name, step, seq, rows)
        mc = D.cell_context(cfg, cell, mesh)
        lm, args = D.live_inputs(cfg, cell, mesh, mc, "cpu",
                                 seed=mesh.rank)
        mesh.counts.clear()
        mesh.traffic.clear()
        _, tr, _ = D.run_step(lm, cfg, cell, mc, args)
        out[f"dry/{name}"] = {
            "counts": dict(mesh.counts),
            "traffic": {k: dict(v) for k, v in mesh.traffic.items()},
            "flops": tr.flops}
    if mesh.rank == 0:
        return out
    return {k: v for k, v in out.items()
            if k.endswith("/collectives") or k.startswith("dry/")}
