"""The port's generative server on the CPU (``--device cpu``).

Closed bucket ladder, zero cell rebuilds after ``warmup`` (checkpoint
swaps included, asserted by the scheduler on every launch), grouped
outputs equal to per-request ``apply``, and the CLI's pointers to later
slices.  Weights swapped in from the JAX package serve the JAX
package's outputs.  After an in-place update of the live params, the
float and the int8 server serve the updated weights.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve_gen import reduced_spec as j_reduced_spec
from repro.models.generative import GenerativeModel as JModel
from repro_torch.convert import params_from_numpy
from repro_torch.launch.batching import pow2_bucket, pow2_floor, take_group
from repro_torch.launch.serve_gen import (GenRequest, GenServer, main,
                                          reduced_specs, serve_async)
from repro_torch.models.generative import GenerativeModel
from repro_torch.serving import ContinuousScheduler


def _server(**kw):
    return GenServer(nets=sorted(reduced_specs()), specs=reduced_specs(),
                     device="cpu", **kw)


def test_dryrun_cli_cpu():
    results, stats = main(["--dryrun", "--device", "cpu"])
    assert stats["served"] == 8 and stats["shed"] == 0
    assert stats["compile_cache"] == [
        "('dcgan-dryrun', 2, 'float32')", "('segnet-dryrun', 2, 'float32')",
        "('voxgan-dryrun', 2, 'float32')", "('wavegan-dryrun', 2, 'float32')"]
    assert results[0].shape == (16, 16, 3)
    assert results[2].shape == (8, 8, 3)
    assert results[4].shape == (8, 8, 8, 1)
    assert results[6].shape == (32, 1)
    _, stats = main(["--dryrun", "--device", "cpu", "--sched", "drain",
                     "--dtype", "bfloat16"])
    assert stats["requests"] == 8


def test_bucket_ladder_is_closed():
    assert [pow2_bucket(n, 16) for n in (1, 2, 3, 5, 9, 16, 40)] == \
        [1, 2, 4, 8, 16, 16, 16]
    assert pow2_floor(12) == 8
    server = _server(max_batch=12)              # clamped to a power of 2
    assert server.max_batch == 8 and server.buckets() == [1, 2, 4, 8]
    assert {server.bucket(n) for n in range(1, 40)} == set(server.buckets())


def test_take_group_fifo_by_key():
    q = ["a1", "b1", "a2", "a3", "b2"]
    group, rest = take_group(q, lambda r: r[0], 2)
    assert group == ["a1", "a2"] and rest == ["b1", "a3", "b2"]


def test_warmup_then_zero_rebuilds_across_swap():
    server = _server(max_batch=4)
    assert server.warmup() == len(reduced_specs()) * len(server.buckets())
    built = server.compile_count
    sched = ContinuousScheduler(server)
    latents = {}
    for i, net in enumerate(("dcgan-dryrun", "segnet-dryrun") * 3):
        latents[i] = server.random_requests(net, 1, seed=i)[0].latent
        sched.submit(net, latents[i], rid=i)
    model, _ = server.model("dcgan-dryrun")
    new = model.init(torch.Generator().manual_seed(7))
    sched.swap_checkpoint("dcgan-dryrun", new)
    results = sched.run()
    assert len(results) == 6 and sched.swaps_applied == 1
    assert server.compile_count == built          # no cell rebuilt
    assert server.model("dcgan-dryrun")[1] is new
    for rid in (0, 2, 4):                         # served on the new weights
        torch.testing.assert_close(
            results[rid], model.apply(new, latents[rid][None])[0],
            rtol=1e-5, atol=1e-5)


def test_grouped_outputs_equal_per_request_apply():
    server = _server(max_batch=8)
    reqs = server.random_requests("dcgan-dryrun", 5, seed=3)
    grouped = server.run_group("dcgan-dryrun", [r.latent for r in reqs])
    assert grouped.shape == (5, 16, 16, 3)        # padding cropped
    model, params = server.model("dcgan-dryrun")
    for r, y in zip(reqs, grouped):
        single = model.apply(params, r.latent[None])[0]
        torch.testing.assert_close(y, single, rtol=1e-5, atol=1e-5)
    results, stats = serve_async(server, reqs)
    assert stats["launches"] == 1 and stats["served"] == 5
    for r in reqs:
        torch.testing.assert_close(results[r.rid], grouped[r.rid])


def test_segnet_head_is_logits_and_fused_backend_matches():
    ref = _server(max_batch=2, backend="torch")
    fused = _server(max_batch=2, backend="fused")
    reqs = ref.random_requests("segnet-dryrun", 2)
    a = ref.run_group("segnet-dryrun", [r.latent for r in reqs])
    b = fused.run_group("segnet-dryrun", [r.latent for r in reqs])
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert ref.model("segnet-dryrun")[0].final_tanh is False
    assert fused.model("segnet-dryrun")[0].engine.backend == "fused"


def test_a_mesh_server_serves_without_deadlines(capsys):
    """Ranks of a mesh server must launch the same groups, and each would
    shed by its own clock: ``--deadline-ms`` with ``--dp``/``--mp`` is a
    usage error, and ``serve_async`` refuses a deadline on a mesh server
    before any collective (a layout-only mesh here), with the requests
    agreed once per run rather than before every batch."""
    from repro_torch.distributed import Mesh
    with pytest.raises(SystemExit):
        main(["--dryrun", "--device", "cpu", "--dp", "2",
              "--dist-backend", "gloo", "--deadline-ms", "50"])
    assert "--deadline-ms needs one process" in capsys.readouterr().err
    server = GenServer(nets=("dcgan-dryrun",), specs=reduced_specs(),
                       device="cpu")
    reqs = server.random_requests("dcgan-dryrun", 2)
    server._mesh = Mesh(1, 2)
    with pytest.raises(ValueError, match="shed by its own clock"):
        serve_async(server, reqs, deadline_ms=50.0)


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--pretune"],
                                   ["--mp", "2"]])
def test_later_slices_point_to_roadmap(flags, tmp_path, monkeypatch,
                                       capsys):
    """``--dp``/``--mp`` and ``--pretune`` are ported.  Outside a process
    group of ``dp * mp`` ranks, ``--dp 2`` and ``--mp 2`` raise the
    launcher's error (the reference raises on too few devices); in
    spawned gloo ranks on the CPU, ``--dp 2 --mp 2`` (4 ranks) and ``--mp
    2`` (2 ranks) serve the dryrun with nothing shed, every rank, each
    cell keyed by its mesh.  ``--pretune`` on the default backend
    (``torch`` on the CPU, no kernel) tunes nothing; on ``fused`` it
    times K1 and K4 on every rank-2 deconv layer of the dryrun specs at
    every bucket before serving, writes measured entries to the plan
    cache and sheds nothing."""
    if flags != ["--pretune"]:
        from repro_torch.launch.mesh import spawn
        from repro_torch.launch.serve_gen import spmd_main
        with pytest.raises(ValueError, match="process group"):
            main(["--dryrun", "--device", "cpu", *flags,
                  "--dist-backend", "gloo"])
        argv = ["--dryrun", "--device", "cpu", "--mp", "2",
                "--dist-backend", "gloo"]
        if flags[0] == "--dp":
            argv += ["--dp", "2"]
        world = 4 if flags[0] == "--dp" else 2
        suffix = "dp2xmp2" if world == 4 else "dp1xmp2"
        for stats in spawn(spmd_main, world, backend="gloo", args=(argv,),
                           timeout_s=240):
            assert stats["served"] == 8 and stats["shed"] == 0, stats
            assert all(suffix in key for key in stats["compile_cache"])
        return
    cache = tmp_path / "sd_plans.json"
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE", str(cache))
    _, stats = main(["--dryrun", "--device", "cpu", *flags])
    assert "pretuned 0 (layer, bucket) geometries over buckets " \
        "[1, 2, 4, 8, 16] in " in capsys.readouterr().out
    assert stats["shed"] == 0 and not cache.exists()
    _, stats = main(["--dryrun", "--device", "cpu", "--backend", "fused",
                     *flags])
    rank2 = [l for sp in reduced_specs().values()
             for l in sp.deconv_layers() if l.rank == 2]
    n = len(rank2) * 5 * 2            # every layer here has 2 or 3 taps
    assert f"pretuned {n} (layer, bucket) geometries over buckets " \
        "[1, 2, 4, 8, 16] in " in capsys.readouterr().out
    assert stats["served"] == 8 and stats["shed"] == 0
    plans = json.loads(cache.read_text())["plans"]
    assert len(plans) == n
    assert all(e["source"] == "measured" and e["backend"] == "cpu"
               for e in plans.values())


@pytest.mark.parametrize("case", ["serves the three reduced specs",
                                  "exits without --dtype int8"])
def test_calib_cli(case, tmp_path, monkeypatch, capsys):
    cache = tmp_path / "sd_calib.json"
    monkeypatch.setenv("REPRO_TORCH_SD_CALIB_CACHE", str(cache))
    if case == "exits without --dtype int8":
        with pytest.raises(SystemExit) as e:
            main(["--dryrun", "--device", "cpu", "--calib", "8"])
        assert e.value.code == 2
        assert "--calib requires --dtype int8" in capsys.readouterr().err
        assert not cache.exists()
        return
    # (the case's id predates the fourth reduced spec, wavegan-dryrun)
    results, stats = main(["--dryrun", "--device", "cpu", "--dtype", "int8",
                           "--calib", "8"])
    assert stats["served"] == 8 and stats["shed"] == 0
    assert stats["compile_cache"] == [
        "('dcgan-dryrun', 2, 'int8')", "('segnet-dryrun', 2, 'int8')",
        "('voxgan-dryrun', 2, 'int8')", "('wavegan-dryrun', 2, 'int8')"]
    assert all(torch.isfinite(r).all() for r in results.values())
    saved = json.loads(cache.read_text())["scales"]
    assert sorted(saved) == ["dcgan-dryrun/max", "segnet-dryrun/max",
                             "voxgan-dryrun/max", "wavegan-dryrun/max"]


def test_swapped_in_reference_weights_serve_reference_outputs():
    jm = JModel(j_reduced_spec(), "sd_kernel", engine_backend="xla")
    jp = jm.init(jax.random.PRNGKey(0))
    z = np.random.RandomState(5).randn(3, 16).astype(np.float32)
    ref = np.asarray(jm.apply(jp, jnp.asarray(z)))
    server = _server(max_batch=4, backend="fused")
    spec = server.model("dcgan-dryrun")[0].spec
    server.swap_checkpoint("dcgan-dryrun", params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu", spec=spec))
    results, stats = serve_async(
        server, [r for r in server.random_requests("dcgan-dryrun", 3)])
    out = server.run_group("dcgan-dryrun", list(torch.from_numpy(z)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert stats["served"] == 3


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("order", ["update_then_serve", "apply_then_serve"])
def test_in_place_update_serves_live_weights(dtype, order):
    """After an in-place update of every layer's ``w`` (as the port's
    ``adamw_update`` does), the server's next batches run the updated
    weights: the cell snapshot is refreshed when the engine is not bound
    to the live params, and follows the engine's plan generation when
    something else (here ``model.apply``) rebound it first.  Reference:
    a fresh model on the live params (``native`` for f32; the int8
    engine's own ``apply``, which binds, for int8)."""
    net = "dcgan-dryrun"
    server = _server(max_batch=4, backend="fused",
                     dtype="int8" if dtype == "int8" else torch.float32)
    latents = [r.latent for r in server.random_requests(net, 3, seed=4)]
    server.run_group(net, latents)                  # snapshot the cell
    model, params = server.model(net)
    with torch.no_grad():
        for p in params.values():
            p["w"].mul_(0.5)
    z = torch.stack(latents)
    if order == "apply_then_serve":
        with torch.no_grad():
            model.apply(params, z)                  # rebinds the engine
    ref_model = (GenerativeModel(model.spec, "native", device="cpu")
                 if dtype == "float32" else
                 GenerativeModel(model.spec, "sd_kernel",
                                 engine_backend="fused", device="cpu",
                                 engine_dtype="int8"))
    with torch.no_grad():
        ref = ref_model.apply(params, z)
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    out = server.run_group(net, latents)
    assert (out - ref).abs().max().item() <= tol
    results, _ = serve_async(server, [GenRequest(i, net, zi)
                                      for i, zi in enumerate(latents)])
    served = torch.stack([results[i] for i in range(len(latents))])
    assert (served - ref).abs().max().item() <= tol
