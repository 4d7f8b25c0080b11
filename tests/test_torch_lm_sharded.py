"""The port's sharded attention decoders against the one-process port and
against the JAX package sharded on forced host devices, on the CPU.

Reduced StableLM-2-12B, Qwen1.5-32B (its q/k/v biases random), DBRX-132B
(``moe_ep``, ``fsdp_serve``), Mixtral-8x7B (``moe_tp``, window 16, the
ring wrapping) and Mixtral at capacity factor 0.5 run in spawned gloo
ranks on dp1 x mp2, dp2 x mp1 and dp2 x mp2 (``tests/_torch_lm_shard.py``
``rank_main``): prefill of 4 prompts, 3 greedy decode steps, the loss
and its grads, one AdamW train step.  The reference runs the same
inputs jitted with its ``param_shardings`` / ``cache_shardings`` /
``batch_shardings`` under ``mesh_context(make_dev_mesh(dp, mp))`` in one
subprocess per mesh (``REF_CODE``), started first so both sides run at
once.  Gates, relative to ``max(1, max|ref|)``: logits and loss 1e-5,
grads 1e-4 of each leaf's max, tokens equal, params after the step by
the rule of ``tests/test_torch_train_infra.py``'s ``_assert_adam_close``.
The capacity-0.5 Mixtral drops entries by dispatch group, and the groups
follow the mesh's data axis: on dp 2 it equals the one-process port
under a layout-only ``mesh_context(Mesh(2, mp))`` and not the
one-process port without one.  Also: each rank's param and cache bytes
against the blocks of the specs, K5's calls on the rank's heads in a
2,064-token prefill, ``serve`` on a mesh, the reduced DBRX's checkpoint
saved from dp2 x mp2 and restored onto one process and onto dp1 x mp2,
and the divisibility refusal of a dim the param specs split into blocks.
The recurrent slots and the frontends:
``tests/test_torch_lm_sharded_recurrent.py``; heads, kv heads and
encoder positions the model axis does not divide:
``tests/test_torch_lm_sharded_uneven.py``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_lm_shard as H
from _torch_hybrid import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.convert import _lm_shapes, lm_params_from_numpy
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.mesh import spawn
from repro_torch.launch.serve import serve
from repro_torch.models.lm import build_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-5          # logits, loss: of max(1, max|ref|)
GRAD_TOL = 1e-4         # grads: of each leaf's max|ref|
PARAM_TOL = 1e-5        # params after the step, where determined
MESH_IDS = [f"dp{dp}xmp{mp}" for dp, mp in H.MESHES]
SPAWN_S = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's sharded port run (rank 0's results and every rank's
    bytes and K5 calls), the reference's runs, and the one-process
    port's under each mesh's layout."""
    tmp = tmp_path_factory.mktemp("lm_shard")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    refs = {}
    for dp, mp in H.MESHES:
        path = str(tmp / f"ref_{dp}x{mp}.npz")
        code = H.REF_CODE.format(tests=os.path.join(REPO, "tests"),
                                 path=path, meshes=[(dp, mp)],
                                 table="CASES")
        refs[(dp, mp)] = (path, subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    ckpt = str(tmp / "ckpt")
    port = {}
    try:
        # dp2 x mp2 saves the checkpoint that dp1 x mp2 restores
        for dp, mp in sorted(H.MESHES, key=lambda m: -m[0] * m[1]):
            port[(dp, mp)] = spawn(H.rank_main, dp * mp, backend="gloo",
                                   args=(dp, mp, ckpt), timeout_s=SPAWN_S)
        one = {(dp, mp): {c: H.flat(H.run_case(c, Mesh(dp, mp)))
                          for c in H.CASES} for dp, mp in H.MESHES}
        plain = H.flat(H.run_case("mixtral_cf"))
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
    return {"port": port, "one": one, "ref": ref, "plain": plain,
            "ckpt": ckpt}


def _case(results: dict, case: str) -> dict:
    pre = f"{case}/"
    return {k[len(pre):]: v for k, v in results.items()
            if k.startswith(pre) and k != f"{case}/collectives"}


def _ref_case(ref: dict, mesh, case: str) -> dict:
    pre = f"{mesh[0]}x{mesh[1]}/{case}/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _assert_close(got: dict, want: dict, what: str):
    """Every quantity of a case: tokens equal; logits, loss, gnorm
    within FWD_TOL; grads within GRAD_TOL of each leaf's max; params
    after the step by the AdamW rule."""
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    loose = total = 0
    for k in sorted(want):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        if k == "decode_tokens":
            assert np.array_equal(a, b), (what, k)
        elif k.startswith("grads/"):
            d = np.abs(a.astype(np.float64) - b).max()
            assert d <= GRAD_TOL * max(np.abs(b).max(), 1e-30), (what, k, d)
        elif k.startswith("new_params/"):
            g = want["grads/" + k[len("new_params/"):]]
            ga = np.abs(g)
            free = (ga > 0) & (ga <= GRAD_TOL * ga.max())
            d = np.abs(a.astype(np.float64) - b)
            tol = PARAM_TOL * max(1.0, float(np.abs(b).max()))
            assert d[~free].max(initial=0.0) <= tol, (what, k)
            assert d[free].max(initial=0.0) <= 2 * H.LR, (what, k)
            loose += int(free.sum())
            total += free.size
        else:
            assert _rel(a, b) <= FWD_TOL, (what, k, _rel(a, b))
    assert loose <= 0.01 * total, (what, loose, total)


@pytest.mark.parametrize("case", list(H.CASES))
@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_sharded_matches_the_one_process_port(runs, mesh, case):
    """The sharded run equals the one-process port under the mesh's
    layout (the same dispatch groups)."""
    got = _case(runs["port"][mesh][0], case)
    _assert_close(got, runs["one"][mesh][case], f"{mesh} {case}")


@pytest.mark.parametrize("case", list(H.CASES))
@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_sharded_matches_the_reference_sharded(runs, mesh, case):
    got = _case(runs["port"][mesh][0], case)
    _assert_close(got, _ref_case(runs["ref"][mesh], mesh, case),
                  f"{mesh} {case} vs the reference")


@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_moe_groups_follow_the_mesh(runs, mesh):
    """Mixtral at capacity 0.5 drops entries: on dp 2 its two dispatch
    groups (one per data rank) give other logits and loss than one
    group; on dp 1 the same."""
    got = _case(runs["port"][mesh][0], "mixtral_cf")
    plain = runs["plain"]
    d = _rel(got["prefill_logits"], plain["prefill_logits"])
    dl = abs(float(got["loss"]) - float(plain["loss"]))
    if mesh[0] == 2:
        assert d > 0.1 and dl > 1e-3, (d, dl)
    else:
        assert d <= FWD_TOL and dl <= FWD_TOL * max(1, abs(float(plain[
            "loss"]))), (d, dl)


@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_rank_bytes_equal_the_specs_blocks(runs, mesh):
    for r in runs["port"][mesh]:
        b = r["bytes"]
        assert b["params"] == b["params_specs"] > 0, b
        assert b["cache"] == b["cache_specs"] > 0, b


@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_k5_runs_on_each_ranks_heads(runs, mesh):
    """A 2,064-token prefill of the reduced StableLM (2 layers, 4 q / 2
    kv heads): on every rank one K5 call per layer on its H/mp q and
    Hkv/mp kv heads, and the logits of the one-process port."""
    cfg = H.config("stablelm", get)
    mp = mesh[1]
    for r in runs["port"][mesh]:
        assert [tuple(c) for c in r["k5_calls"]] == [
            (cfg.n_heads // mp, cfg.n_kv_heads // mp)] * cfg.n_layers
    lm = build_lm(cfg, device="cpu")
    params = lm_params_from_numpy(H.draw(_lm_shapes(cfg)), cfg, "cpu")
    with torch.no_grad():
        want, _ = lm.prefill(params, {"inputs": torch.from_numpy(
            H.tokens(cfg, 2, 2064, 4))}, lm.init_cache(2, 2080))
    assert _rel(runs["port"][mesh][0]["k5_logits"], want) <= FWD_TOL


@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_serve_on_a_mesh_gives_the_one_process_tokens(runs, mesh):
    cfg = H.config("stablelm", get)
    params = lm_params_from_numpy(H.draw(_lm_shapes(cfg)), cfg, "cpu")
    want, _ = serve(cfg, H.tokens(cfg, 3, 6, 5).tolist(), max_new=4,
                    slots=4, max_len=16, params=params, device="cpu")
    assert [list(t) for t in runs["port"][mesh][0]["serve"]] == [
        want[i] for i in range(3)]


@pytest.mark.parametrize("mesh", H.MESHES, ids=MESH_IDS)
def test_collectives_follow_the_mesh_axes(runs, mesh):
    """Model-axis collectives exactly where the model axis has ranks,
    data-axis ones exactly where the data axis has."""
    dp, mp = mesh
    for case in H.CASES:
        got = runs["port"][mesh][0][f"{case}/collectives"]
        axes = {k.split("/")[1] for k, n in got.items() if n}
        assert axes == {a for a, n in (("data", dp), ("model", mp))
                        if n > 1}, (case, got)


def test_elastic_restore_of_a_sharded_dbrx(runs):
    """The reduced DBRX saved from dp2 x mp2 (``fsdp_serve``: its
    weights split over both axes) restores onto one process bit for bit,
    and onto dp1 x mp2 (its blocks there bit for bit, checked in the
    ranks)."""
    cfg = H.config("dbrx", get)
    full = lm_params_from_numpy(H.draw(_lm_shapes(cfg)), cfg, "cpu")
    _, got = CheckpointManager(runs["ckpt"]).restore(full)
    for path, t in SH._tree_paths(full):
        g = dict(SH._tree_paths(got))[path]
        assert torch.equal(g, t), path
    assert runs["port"][(1, 2)][0]["restore_equal"] is True


def _live(dp: int, mp: int) -> Mesh:
    """A mesh that claims process groups, for refusals that come before
    any collective."""
    groups = {a: object() for a, n in (("data", dp), ("model", mp))
              if n > 1}
    return Mesh(dp, mp, groups=groups)


@pytest.mark.parametrize("name, value, mp", [("d_ff", 127, 2)])
def test_a_model_axis_that_does_not_divide_is_refused(name, value, mp):
    cfg = dataclasses.replace(H.config("stablelm", get), **{name: value})
    lm = build_lm(cfg, device="cpu")
    with SH.mesh_context(_live(1, mp)):
        with pytest.raises(ValueError, match=name):
            lm.init_cache(4, 16)
