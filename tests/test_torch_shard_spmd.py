"""The port's scale-out against the JAX package's own sharded runs.

The same numpy inputs go through the reference's ``shard_map`` path on
two forced host devices (``XLA_FLAGS=--xla_force_host_platform_device_
count=2`` in a subprocess, as ``tests/conftest.py`` does; the ``xla``
backend, the one this jax runs on the CPU) and through the port in two
spawned gloo ranks on the CPU (:func:`repro_torch.launch.mesh.spawn`,
rank bodies in ``tests/_torch_spmd.py``): ``execute_spmd`` on a dp1 x mp2
mesh for the reference's parity cases on every port backend (and dp2 x
mp1), the sharded ``conv_transpose``'s loss and grads, and one sharded
SGD step on ``dcgan-dryrun`` at mp 2 and at dp 2.  Gates: forward 1e-5
of ``max(1, max|ref|)`` (K4's plain version at its Winograd tolerance),
int8 sharded == unsharded exactly, loss 1e-5 relative, grads and new
params 1e-4 (a train step's grads of the leaf's largest).  A 4-rank dp2 x mp2 ``GenServer`` on the reduced specs is
held to the one-process server at 1e-5.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import _torch_spmd as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_S = 240            # each spawn's deadline; every rank's collectives

JAX_REF = """
import sys
import numpy as np, jax, jax.numpy as jnp
import repro.sd as sd
from repro.launch.mesh import make_dev_mesh
from repro.launch.serve_gen import reduced_specs
from repro.launch.train_gen import make_sharded_train_step, place_params
from repro.models.generative import GenerativeModel
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
assert jax.device_count() == 2
d = dict(np.load(sys.argv[1]))
cases = {cases!r}
meshes = {{tag: make_dev_mesh(dp, mp) for tag, dp, mp in {meshes!r}}}
mesh = meshes["mp2"]
out = {{}}
for i, (_, _, s, dt, _) in enumerate(cases):
    x, w, b = (jnp.asarray(d[f"c{{i}}_{{n}}"]) for n in "xwb")
    p = sd.plan(w.shape, s, 1, backend="xla", act="relu", dtype=dt)
    bp = p.bind(w, bias=b, mesh=mesh, axis="model")
    assert bp.shards == 2
    out[f"c{{i}}"] = np.asarray(sd.execute_spmd(bp, x, mesh))
x, w = jnp.asarray(d["g_x"]), jnp.asarray(d["g_w"])
ps = sd.plan(w.shape, 2, 1, backend="xla").with_shards(2, "model")
def gstep(xx, wl):
    f = lambda a, c: jnp.sum(sd.conv_transpose(ps, a, c) ** 2)
    return jax.value_and_grad(f, argnums=(0, 1))(xx, wl)
l, (gx, gw) = jax.jit(shard_map(
    gstep, mesh=mesh, in_specs=(P(), P(None, None, None, "model")),
    out_specs=(P(), (P(), P(None, None, None, "model"))),
    check_rep=False))(x, w)
out.update(g_loss=np.asarray(l), g_x=np.asarray(gx), g_w=np.asarray(gw))
spec = reduced_specs()["dcgan-dryrun"]
model = GenerativeModel(spec, deconv_impl="sd_kernel", engine_backend="xla")
params = {{}}
for k, v in d.items():
    if k.startswith("p_"):
        layer, name = k[2:].rsplit("_", 1)
        params.setdefault(layer, {{}})[name] = jnp.asarray(v)
z, t = jnp.asarray(d["t_z"]), jnp.asarray(d["t_target"])
for tag, m in meshes.items():
    stepf, specs = make_sharded_train_step(model, m, lr=1e-2)
    gstepf, _ = make_sharded_train_step(model, m, lr={grad_lr!r})
    placed = place_params(params, m, specs)
    new, loss = stepf(placed, z, t)
    gnew, _ = gstepf(placed, z, t)
    out[f"t_{{tag}}_loss"] = np.asarray(loss)
    for k in new:
        for n in new[k]:
            out[f"t_{{tag}}_{{k}}_{{n}}"] = np.asarray(new[k][n])
            out[f"tg_{{tag}}_{{k}}_{{n}}"] = (
                np.asarray(params[k][n]) - np.asarray(gnew[k][n])
            ) / {grad_lr!r}
np.savez(sys.argv[2], **out)
print("JAX_REF_OK")
"""


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's sharded run and the port's, on one set of
    inputs: ``(jax outputs, [rank 0's, rank 1's])``."""
    from repro_torch.launch.mesh import spawn
    tmp = tmp_path_factory.mktemp("spmd")
    inp, ref = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    np.savez(inp, **W.make_inputs(0))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2"))
    code = JAX_REF.format(cases=W.CASES, meshes=W.MESHES,
                          grad_lr=W.GRAD_LR)
    proc = subprocess.run([sys.executable, "-c", code, inp, ref],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    port = spawn(W.port_worker, 2, backend="gloo", args=(inp,),
                 timeout_s=SPAWN_S)
    return dict(np.load(ref)), port


PARITY = [(i, be) for i, c in enumerate(W.CASES) for be in c[4]]


@pytest.mark.parametrize("case,backend", PARITY,
                         ids=[f"c{i}-{be}" for i, be in PARITY])
def test_execute_spmd_matches_reference(runs, case, backend):
    """Each rank's ``execute_spmd`` on dp1 x mp2 (2 shards, each rank
    holding half of the split channels) equals the JAX package's sharded
    run on ``xla``, on both ranks; int8 is bit-identical to the port's
    unsharded run, f32 within 1e-5 of it."""
    from repro_torch.kernels.winograd import tolerance
    jref, port = runs
    _, ws, s, dt, _ = W.CASES[case]
    rank = len(ws) - 2
    kt = -(-ws[0] // s)
    tol = tolerance((kt,) * rank) if backend == "winograd" else 1e-5
    for r in port:
        y, un = r[f"c{case}_{backend}"], r[f"c{case}_{backend}_un"]
        assert r[f"c{case}_{backend}_shards"] == 2
        assert r[f"c{case}_{backend}_local_ws"] * 2 == ws[-1] * s ** rank
        assert y.shape == jref[f"c{case}"].shape
        assert _rel(y, jref[f"c{case}"]) <= tol, (backend, r)
        if dt == "int8":
            np.testing.assert_array_equal(y, un)
        else:
            assert _rel(y, un) <= 1e-5


@pytest.mark.parametrize("backend", ["torch", "fused", "winograd"])
def test_execute_spmd_over_the_data_axis(runs, backend):
    """dp2 x mp1: each rank runs one sample and the batch is gathered."""
    jref, port = runs
    for r in port:
        assert _rel(r[f"c0_{backend}_dp2"], r[f"c0_{backend}_un"]) <= 1e-5
        assert r[f"c0_{backend}_dp2"].shape == jref["c0"].shape


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_sharded_conv_transpose_grads(runs, backend):
    """Loss within 1e-5 relative, dx (summed over the model axis) whole
    on every rank and dw's Cout blocks, put together, within 1e-4 of the
    JAX package's ``shard_map`` grads."""
    jref, port = runs
    for r in port:
        np.testing.assert_allclose(r[f"g_{backend}_loss"], jref["g_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r[f"g_{backend}_x"], jref["g_x"],
                                   rtol=1e-4, atol=1e-4)
    gw = np.concatenate([r[f"g_{backend}_w"] for r in port], axis=-1)
    np.testing.assert_allclose(gw, jref["g_w"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tag", [t for t, _, _ in W.MESHES])
def test_sharded_train_step(runs, tag):
    """One sharded SGD step on ``dcgan-dryrun`` (fused backend, the
    kernels' plain versions on the CPU): loss within 1e-5 relative and
    every new param within 1e-4 of the JAX package's sharded step and of
    the port's one-process step; a sharded filter comes back as the
    rank's Cout block.  Every leaf's gradient, read as ``(p - new)/lr``
    from a step at ``W.GRAD_LR`` (at lr 1e-2 the update is under the
    params' gate) and the Cout blocks put together, within 1e-4 of the
    leaf's largest reference gradient of both."""
    jref, port = runs
    spec = W.train_spec()
    for r in port:
        np.testing.assert_allclose(r[f"t_{tag}_loss"], jref[f"t_{tag}_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r[f"t_{tag}_loss"], r["t_one_loss"],
                                   rtol=1e-5)
    for layer in spec.layers:
        for name in ("w", "b") + (("scale",) if layer.kind != "fc" else ()):
            key = f"t_{tag}_{layer.name}_{name}"
            sharded = "model" in port[0][key + "_spec"]
            got = (np.concatenate([r[key] for r in port], axis=-1)
                   if sharded else port[0][key])
            if sharded:
                assert port[0][key].shape[-1] * 2 == layer.cout
            else:
                np.testing.assert_array_equal(port[1][key], port[0][key])
            ref = jref[key]
            assert got.shape == ref.shape
            assert np.abs(got - ref).max() < 1e-4, key
            assert np.abs(got - port[0][f"t_one_{layer.name}_{name}"]
                          ).max() < 1e-4, key
            gkey = f"tg_{tag}_{layer.name}_{name}"
            g = (np.concatenate([r[gkey] for r in port], axis=-1)
                 if sharded else port[0][gkey])
            if not sharded:
                np.testing.assert_array_equal(port[1][gkey], port[0][gkey])
            for g_ref in (jref[gkey], port[0][f"tg_one_{layer.name}_{name}"]):
                gate = 1e-4 * np.abs(g_ref).max()
                assert gate > 0 and np.abs(g - g_ref).max() <= gate, (
                    gkey, np.abs(g - g_ref).max(), gate)


def test_dp2xmp2_server_matches_one_process_server():
    """A 4-rank dp2 x mp2 ``GenServer`` (fused backend) on every reduced
    spec equals the one-process server within 1e-5 of ``max(1,
    max|ref|)``; its bucket rounds to a multiple of dp, its cell key ends
    in ``dp2xmp2``, a checkpoint swap builds no cell, and the engines
    report their shards."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve_gen import reduced_specs
    out = spawn(W.server_worker, 4, backend="gloo", timeout_s=SPAWN_S)
    for r in out:
        assert max(r["diff"].values()) <= 1e-5, r["diff"]
        assert r["bucket3"] == 4 and r["buckets"] == [2, 4, 8, 16]
        assert r["key"] == ("dcgan-dryrun", 4, "float32", "dp2xmp2")
        assert r["cells_before_swap"] == r["cells_after_swap"]
        assert r["estimate_ms"] is None          # nothing measured
        assert "mesh=dp2xmp2" in r["describe_dcgan-dryrun"]
        assert "d1: " in r["describe_dcgan-dryrun"]
        d1 = next(l for l in r["describe_dcgan-dryrun"].splitlines()
                  if "d1:" in l)
        d2 = next(l for l in r["describe_dcgan-dryrun"].splitlines()
                  if "d2:" in l)
        assert "shards=2@model" in d1 and "shards" not in d2
        for net, spec in reduced_specs().items():
            assert r[f"shape_{net}"][0] == 3


def test_mesh_pretune_times_each_ranks_block_and_agrees(tmp_path):
    """A dp1 x mp2 engine's pretune times each rank's own launch, its
    Cout block with no gather (a plan of one shard, ``cout_local``
    channels), and keeps on every rank the tile whose slowest rank's
    reading is least; both ranks write the same entries, and
    ``estimate_ms`` sums them."""
    from repro_torch.launch.mesh import spawn
    out = spawn(W.pretune_worker, 2,
                backend="gloo", args=(str(tmp_path / "plans.json"),),
                timeout_s=SPAWN_S)
    spec = W.train_spec()
    d1, d2 = spec.deconv_layers()
    assert out[0]["shards"] == {"d1": 2, "d2": 1}
    for r in out:
        assert r["timed"], "nothing was timed"
        for shards, cout, nc, nb, batch in r["timed"]:
            assert shards == 1 and nb == cout and batch == 2
            assert cout in (d1.cout // 2, d2.cout)
    assert out[0]["winners"] == out[1]["winners"]
    assert set(out[0]["winners"]) == {(d1.cin, "fused"), (d1.cin, "winograd"),
                                      (d2.cin, "fused"), (d2.cin, "winograd")}
    alone = 0
    for group, tile in out[0]["winners"].items():
        worst = {t: max(r["readings"][group][t] for r in out)
                 for t in out[0]["readings"][group]}
        assert tile == min(worst, key=worst.get), group
        mine = out[0]["readings"][group]
        alone += min(mine, key=mine.get) != tile
    assert alone, "the fake readings never split the ranks"
    assert out[0]["estimate_ms"] == out[1]["estimate_ms"] is not None


def test_a_failed_or_hung_rank_fails_the_spawn():
    """A rank that raises fails the spawn with its traceback (its peer,
    left at a barrier, is ended); ranks still running at the deadline (one
    asleep, its peer waiting for it at a barrier) fail it too, and no rank
    outlives the call."""
    from repro_torch.launch.mesh import spawn
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*gives up"):
        spawn(W.failing_worker, 2, backend="gloo", timeout_s=60)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] still running"):
        spawn(W.hanging_worker, 2, backend="gloo", timeout_s=15)
    assert time.monotonic() - t0 < 60
