"""The port's sharded recurrent slots and frontends against the
one-process port and against the JAX package sharded on forced host
devices, on the CPU.

Reduced Jamba-1.5-Large (Mamba, attention and ``moe_ep`` slots,
``fsdp_serve``), xLSTM-350M (mLSTM and sLSTM), InternVL2-76B (the patch
projector) and Whisper-small (the encoder-decoder) run in spawned gloo
ranks on dp1 x mp2, dp2 x mp1 and dp2 x mp2
(``tests/_torch_lm_shard.py`` ``recurrent_rank_main``, the case table
``RECURRENT``): prefill of 4 prompts (with their patches or frames), 3
greedy decode steps, the loss and its grads, one AdamW train step.  The
reference runs the same inputs jitted with its shardings in one
subprocess per mesh (``REF_CODE`` on the table), started first.  Every
leaf is drawn from a seed of its path (``draw``), so Mamba's
``conv_b`` / ``dt_bias`` and every other zero-initialised leaf are
random.

Gates, as ``tests/test_torch_lm_sharded.py``'s: logits and loss within
1e-5 of ``max(1, max|ref|)``, grads (and their global norm) within 1e-4
of each leaf's max, greedy tokens equal, params after the step by the
AdamW rule of ``tests/test_torch_train_infra.py``'s
``_assert_adam_close``.  Each gate is the larger of that and four times the
one-process port's own spread over the same quantity (ROADMAP's rule
for whole-model xLSTM), taken here as its move when every param moves
by one f32 ulp, a perturbation at the level of a reordered sum: with
every leaf random, the reduced Jamba's grads move by 5.1e-4 of a
leaf's max under it and xLSTM's by 5.6e-3, past the tight gates;
InternVL2's and Whisper's quantities move by at most 6.2e-6.  Also:
each rank's param bytes and every cache leaf (``conv``, ``ssm``, ``c``,
``n``, ``m``, ``h``, ``k``, ``v``, ``kpos``, ``cross_k``, ``cross_v``)
against the specs' blocks, bytes and values; the collectives of a prefill equal at S and 2 S prompt
tokens; K5 on each rank's heads in prefills of the reduced Jamba and
InternVL2 past 2,048 positions; ``serve`` on a mesh for xLSTM and Jamba;
and the model axis's divisibility refusals.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_lm_shard as H
from _torch_hybrid import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.configs import get
from repro_torch.convert import _lm_shapes, lm_params_from_numpy
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.mesh import spawn
from repro_torch.launch.serve import serve
from repro_torch.models.lm import build_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-5          # logits, loss: of max(1, max|ref|)
GRAD_TOL = 1e-4         # grads, gnorm: of each leaf's max|ref|
PARAM_TOL = 1e-5        # params after the step, where determined
MESH_IDS = [f"dp{dp}xmp{mp}" for dp, mp in H.MESHES]
CASES = list(H.RECURRENT)
SPAWN_S = 300


_DRAW = H.draw


def _ulp_draw(shapes, seed: int = H.SEED, prefix: str = ""):
    """``H.draw``'s tree with every element moved by one f32 ulp up or
    down (signs from a seed of the leaf's path)."""
    tree = _DRAW(shapes, seed, prefix)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(t)]
        rng = np.random.RandomState(sum(map(ord, path)) % 2 ** 31)
        step = np.float32(2.0 ** -23) * rng.choice([-1, 1], t.shape)
        return (t * (1 + step)).astype(np.float32)
    return walk(tree, prefix)


def _spread(case: str, base: dict) -> dict:
    """The one-process port's own move on ``case`` from its results
    ``base`` when every param moves by one f32 ulp: the largest of each
    quantity's errors as the gates measure them (logits / loss / gnorm
    of ``max(1, max|ref|)`` and each grad leaf of its max, params of
    ``max(1, max|ref|)``)."""
    H.draw = _ulp_draw
    try:
        moved = H.flat(H.run_case(case))
    finally:
        H.draw = _DRAW
    out = {}
    for k, b in base.items():
        kind = k.split("/")[0]
        a = moved[k]
        if kind == "new_params":    # where the AdamW rule holds them
            kept = ~_free(base["grads/" + k[len("new_params/"):]])
            a, b = np.asarray(a)[kept], np.asarray(b)[kept]
        out[kind] = max(out.get(kind, 0.0), _err(kind, a, b))
    return out


def _free(g) -> np.ndarray:
    """The elements whose gradient sits at the sums' rounding level
    (the AdamW rule of ``tests/test_torch_train_infra.py``'s
    ``_assert_adam_close``): nonzero, at most GRAD_TOL of the leaf's
    max."""
    g = np.abs(np.asarray(g))
    return (g > 0) & (g <= GRAD_TOL * g.max())


def _err(kind: str, a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = float(np.abs(a - b).max(initial=0.0))
    if kind == "grads":
        return d / max(float(np.abs(b).max()), 1e-30)
    return d / max(1.0, float(np.abs(b).max(initial=0.0)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's sharded port run (rank 0's results, every rank's
    bytes, cache leaves, prefill collectives and K5 calls), the
    reference's runs, the one-process port's under each mesh's layout,
    and each case's spread."""
    tmp = tmp_path_factory.mktemp("lm_shard_rec")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    refs = {}
    for dp, mp in H.MESHES:
        path = str(tmp / f"ref_{dp}x{mp}.npz")
        code = H.REF_CODE.format(tests=os.path.join(REPO, "tests"),
                                 path=path, meshes=[(dp, mp)],
                                 table="RECURRENT")
        refs[(dp, mp)] = (path, subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        port = {(dp, mp): spawn(H.recurrent_rank_main, dp * mp,
                                backend="gloo", args=(dp, mp),
                                timeout_s=SPAWN_S) for dp, mp in H.MESHES}
        # the layout reaches only the MoE's dispatch groups (Jamba's)
        alone = {c: H.flat(H.run_case(c)) for c in CASES}
        one = {(dp, mp): {c: H.flat(H.run_case(c, Mesh(dp, mp)))
                          if H.config(c, get).n_experts else alone[c]
                          for c in CASES} for dp, mp in H.MESHES}
        spread = {c: _spread(c, alone[c]) for c in CASES}
        ref = {}
        for m, (path, proc) in refs.items():
            out, err = proc.communicate(timeout=SPAWN_S)
            assert proc.returncode == 0 and "REF_OK" in out, err[-3000:]
            with np.load(path) as f:
                ref[m] = {k: f[k] for k in f.files}
    finally:
        for _, proc in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"port": port, "one": one, "ref": ref, "spread": spread}


def _case(results: dict, case: str) -> dict:
    pre = f"{case}/"
    rest = ("collectives", "bytes", "cache", "prefill_counts", "k5_calls",
            "k5_logits", "serve")
    return {k[len(pre):]: v for k, v in results.items()
            if k.startswith(pre) and k[len(pre):].split("/")[0] not in rest}


def _ref_case(ref: dict, mesh, case: str) -> dict:
    pre = f"{mesh[0]}x{mesh[1]}/{case}/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _assert_close(got: dict, want: dict, spread: dict, what: str):
    """Every quantity of a case: tokens equal; logits and loss within
    FWD_TOL, grads and gnorm within GRAD_TOL, params after the step by
    the AdamW rule, each gate at least four times ``spread``'s.  The
    rule's 1% share of loosely held elements is taken over the leaves
    other than the vocabulary's, as chip_smoke's phase 19 (d) takes it:
    with xLSTM's tied embeddings the rows of tokens the batch does not
    hold get softmax-sized gradients, 4.3% of all elements; those are
    held within 2 lr like every loose element."""
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    loose = total = 0
    for k in sorted(want):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        kind = k.split("/")[0]
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        if kind == "decode_tokens":
            assert np.array_equal(a, b), (what, k)
        elif kind == "new_params":
            free = _free(want["grads/" + k[len("new_params/"):]])
            d = np.abs(a.astype(np.float64) - b)
            tol = max(PARAM_TOL * max(1.0, float(np.abs(b).max())),
                      4 * spread[kind])
            assert d[~free].max(initial=0.0) <= tol, (what, k)
            assert d[free].max(initial=0.0) <= 2 * H.LR, (what, k)
            if k.rsplit("/", 1)[-1] not in ("embed", "head"):
                loose += int(free.sum())
                total += free.size
        else:
            tight = GRAD_TOL if kind in ("grads", "gnorm") else FWD_TOL
            err = _err("grads" if kind == "grads" else kind, a, b)
            assert err <= max(tight, 4 * spread[kind]), (what, k, err)
    assert loose <= 0.01 * total, (what, loose, total)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_sharded_matches_the_one_process_port(runs, mesh, case):
    got = _case(runs["port"][mesh][0], case)
    _assert_close(got, runs["one"][mesh][case], runs["spread"][case],
                  f"{mesh} {case}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_sharded_matches_the_reference_sharded(runs, mesh, case):
    got = _case(runs["port"][mesh][0], case)
    _assert_close(got, _ref_case(runs["ref"][mesh], mesh, case),
                  runs["spread"][case], f"{mesh} {case} vs the reference")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_rank_bytes_and_cache_leaves_equal_the_specs_blocks(runs, mesh,
                                                            case):
    """Every rank's param bytes equal its specs' blocks; every cache
    leaf's bytes equal its spec's block, and its fresh values equal that
    block of the one-process cache (``m`` at -1e30, ``kpos`` at -1)."""
    kinds = set()
    for r in runs["port"][mesh]:
        b = r[f"{case}/bytes"]
        assert b["params"] == b["params_specs"] > 0, b
        for path, (have, want, same) in r[f"{case}/cache"].items():
            assert have == want > 0 and same, (path, have, want, same)
            kinds.add(path.rsplit("/", 1)[-1])
    expect = {"jamba": {"conv", "ssm", "k", "v", "kpos"},
              "xlstm": {"c", "n", "m", "h"},
              "internvl2": {"k", "v", "kpos"},
              "whisper": {"k", "v", "kpos", "cross_k", "cross_v"}}[case]
    assert kinds == expect, kinds


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_prefill_collectives_do_not_grow_with_the_prompt(runs, mesh, case):
    """A prefill's collectives are the same at S and 2 S prompt tokens
    (no collective inside a time or chunk loop); there are some wherever
    the model axis has ranks, and on the data axis only where a leaf is
    split over it to serve (Jamba's ``fsdp_serve``)."""
    fsdp = H.config(case, get).fsdp_serve
    for r in runs["port"][mesh]:
        at_s, at_2s = r[f"{case}/prefill_counts"]
        assert at_s == at_2s, (at_s, at_2s)
        axes = {k.split("/")[1] for k in at_s}
        assert axes == ({"model"} if mesh[1] > 1 else set()) | (
            {"data"} if mesh[0] > 1 and fsdp else set()), at_s


@pytest.mark.parametrize("case", ["jamba", "internvl2"])
@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_k5_runs_on_each_ranks_heads(runs, mesh, case):
    """A prefill of 2,064 positions (InternVL2's 8 patches ahead of
    2,056 tokens): on every rank one K5 call per attention layer, on its
    H/mp q and Hkv/mp kv heads, and the logits of the one-process
    port."""
    cfg = H.config(case, get)
    mp = mesh[1]
    n_attn = cfg.pattern.count("a") * (cfg.n_layers // len(cfg.pattern))
    for r in runs["port"][mesh]:
        assert [tuple(c) for c in r[f"{case}/k5_calls"]] == [
            (cfg.n_heads // mp, cfg.n_kv_heads // mp)] * n_attn
    lm = build_lm(cfg, device="cpu")
    params = lm_params_from_numpy(H.draw(_lm_shapes(cfg)), cfg, "cpu")
    batch = {"inputs": torch.from_numpy(H.tokens(cfg, 2, H.LONG
                                                 - cfg.n_patches, 4)),
             **{k: torch.from_numpy(v)
                for k, v in H.embeds(cfg, 2, 8).items()}}
    with torch.no_grad():
        want, _ = lm.prefill(params, batch, lm.init_cache(2, H.LONG + 16))
    got = runs["port"][mesh][0][f"{case}/k5_logits"]
    assert _err("logits", got, want) <= max(
        FWD_TOL, 4 * runs["spread"][case]["prefill_logits"])


@pytest.mark.parametrize("case", ["jamba", "xlstm"])
@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_serve_on_a_mesh_gives_the_one_process_tokens(runs, mesh, case):
    cfg = H.config(case, get)
    params = lm_params_from_numpy(H.draw(_lm_shapes(cfg)), cfg, "cpu")
    want, _ = serve(cfg, H.tokens(cfg, 3, 6, 5).tolist(), max_new=4,
                    slots=4, max_len=16, params=params, device="cpu")
    assert [list(t) for t in runs["port"][mesh][0][f"{case}/serve"]] == [
        want[i] for i in range(3)]


@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_collectives_follow_the_mesh_axes(runs, mesh):
    """Model-axis collectives exactly where the model axis has ranks,
    data-axis ones exactly where the data axis has."""
    dp, mp = mesh
    for case in CASES:
        got = runs["port"][mesh][0][f"{case}/collectives"]
        axes = {k.split("/")[1] for k, n in got.items() if n}
        assert axes == {a for a, n in (("data", dp), ("model", mp))
                        if n > 1}, (case, got)


def _live(dp: int, mp: int) -> Mesh:
    """A mesh that claims process groups, for refusals that come before
    any collective."""
    groups = {a: object() for a, n in (("data", dp), ("model", mp))
              if n > 1}
    return Mesh(dp, mp, groups=groups)


@pytest.mark.parametrize("arch, over, name, mp", [
    ("jamba-1.5-large-398b", {"mamba_expand": 1, "d_model": 65},
     "mamba_expand*d_model", 2),
    ("xlstm-350m", {"n_heads": 6, "n_kv_heads": 6, "vocab_pad_to": 384},
     "slstm_inner_dim", 3),
    ("internvl2-76b", {"d_model": 65}, "d_model", 2),
    ("whisper-small", {"d_model": 65}, "d_model", 2),
])
def test_a_model_axis_that_does_not_divide_is_refused(arch, over, name, mp):
    cfg = dataclasses.replace(get(arch).reduced(), **over)
    lm = build_lm(cfg, device="cpu")
    with SH.mesh_context(_live(1, mp)):
        with pytest.raises(ValueError, match=re.escape(name)):
            lm.init_cache(4, 16)
