"""Rank bodies of the port's SPMD tests (``tests/test_torch_shard_spmd.py``,
``tests/test_torch_serve_gen.py``, ``tests/test_torch_train_infra.py``), run in spawned gloo ranks on the CPU
by :func:`repro_torch.launch.mesh.spawn`.  Torch and numpy only: a
spawned rank imports this module by name.

``CASES`` are the reference's Cout-shard parity cases
(``tests/test_shard.py``'s ``_PARITY_2DEV``) with the port's backends
(``torch`` for the reference's ``xla``): 2-D at stride 2 and 3, 1-D,
3-D, and int8.
"""

from __future__ import annotations

import numpy as np

# (x shape, w shape, stride, dtype, the port's backends)
CASES = [
    ((2, 5, 6, 3), (4, 4, 3, 8), 2, "native", ("torch", "fused", "winograd")),
    ((2, 5, 6, 3), (5, 5, 3, 6), 3, "native", ("torch", "fused")),
    ((2, 7, 4), (4, 4, 8), 2, "native", ("torch", "fused", "winograd")),
    ((1, 3, 4, 5, 2), (4, 4, 4, 2, 4), 2, "native", ("torch", "fused")),
    ((2, 5, 6, 3), (4, 4, 3, 8), 2, "int8", ("torch", "fused")),
]
GRAD_X, GRAD_W = (2, 5, 6, 3), (4, 4, 3, 8)
TRAIN_BATCH = 2
# A train step at this lr reads the gradient: (p - new) / lr is g to f32
# rounding once lr*|g| dwarfs |p| (at lr 1e-2 the update sits under the
# new params' gate, which then cannot see a wrong gradient).
GRAD_LR = 1e6
MESHES = (("mp2", 1, 2), ("dp2", 2, 1))


def train_spec():
    from repro_torch.launch.serve_gen import reduced_specs
    return reduced_specs()["dcgan-dryrun"]


def make_inputs(seed: int = 0) -> dict:
    """Every input of the parity, grad and train checks, numpy f32."""
    rng = np.random.RandomState(seed)
    d = {}
    for i, (xs, ws, _, _, _) in enumerate(CASES):
        d[f"c{i}_x"] = rng.randn(*xs).astype(np.float32)
        d[f"c{i}_w"] = rng.randn(*ws).astype(np.float32)
        d[f"c{i}_b"] = rng.randn(ws[-1]).astype(np.float32)
    d["g_x"] = rng.randn(*GRAD_X).astype(np.float32)
    d["g_w"] = rng.randn(*GRAD_W).astype(np.float32)
    spec = train_spec()
    for l in spec.layers:
        if l.kind == "fc":
            d[f"p_{l.name}_w"] = (rng.randn(l.cin, l.cout)
                                  / np.sqrt(l.cin)).astype(np.float32)
        else:
            d[f"p_{l.name}_w"] = (rng.randn(*(l.k,) * l.rank, l.cin, l.cout)
                                  / np.sqrt(l.k ** l.rank * l.cin)
                                  ).astype(np.float32)
            d[f"p_{l.name}_scale"] = (1 + 0.1 * rng.randn(l.cout)).astype(
                np.float32)
        d[f"p_{l.name}_b"] = (0.1 * rng.randn(l.cout)).astype(np.float32)
    last = spec.layers[-1]
    d["t_z"] = rng.randn(TRAIN_BATCH, spec.layers[0].cin).astype(np.float32)
    d["t_target"] = rng.randn(TRAIN_BATCH, *last.out_hw(),
                              last.cout).astype(np.float32)
    return d


def numpy_params(d: dict) -> dict:
    out = {}
    for key, v in d.items():
        if key.startswith("p_"):
            layer, name = key[2:].rsplit("_", 1)
            out.setdefault(layer, {})[name] = v
    return out


def port_worker(rank: int, world: int, path: str) -> dict:
    """One rank of the port's sharded runs on the CPU: ``execute_spmd``
    of every case and backend on a dp1 x mp2 mesh (and case 0 on dp2 x
    mp1) beside the unsharded ``execute``; the sharded
    ``conv_transpose``'s loss and grads (``torch`` and ``fused``); a
    sharded train step on ``dcgan-dryrun`` at mp 2 and at dp 2, with the
    one-process step beside it, and each step's gradients (``tg_``) read
    from a step at ``GRAD_LR``.  Local blocks come back as they are."""
    import torch
    from repro_torch import sd
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import local_block, spmd
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.train_gen import (make_sharded_train_step,
                                              make_train_step, place_params)
    from repro_torch.models.generative import GenerativeModel

    d = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
    meshes = {tag: make_dev_mesh(dp, mp, backend="gloo", device="cpu")
              for tag, dp, mp in MESHES}
    mesh = meshes["mp2"]
    out = {}
    for i, (_, _, s, dt, backends) in enumerate(CASES):
        x, w, b = d[f"c{i}_x"], d[f"c{i}_w"], d[f"c{i}_b"]
        for be in backends:
            p = sd.plan(w.shape, s, 1, backend=be, act="relu", dtype=dt,
                        device="cpu")
            bp = p.bind(w, bias=b, mesh=mesh)
            out[f"c{i}_{be}_shards"] = bp.shards
            out[f"c{i}_{be}_local_ws"] = bp.ws.shape[-1]
            out[f"c{i}_{be}"] = sd.execute_spmd(bp, x, mesh)
            out[f"c{i}_{be}_un"] = sd.execute(p.bind(w, bias=b), x)
            if i == 0:
                out[f"c{i}_{be}_dp2"] = sd.execute_spmd(
                    p.bind(w, bias=b), x, meshes["dp2"])
    wl_spec = (None, None, None, "model")
    for be in ("torch", "fused"):
        ps = sd.plan(GRAD_W, 2, 1, backend=be, device="cpu").with_shards(
            2, "model")
        xx = d["g_x"].clone().requires_grad_(True)
        wl = local_block(d["g_w"], wl_spec, mesh).requires_grad_(True)
        with spmd(mesh):
            loss = (sd.conv_transpose(ps, xx, wl) ** 2).sum()
            gx, gw = torch.autograd.grad(loss, [xx, wl])
        out.update({f"g_{be}_loss": loss.detach(), f"g_{be}_x": gx,
                    f"g_{be}_w": gw})
    spec = train_spec()
    model = GenerativeModel(spec, "sd_kernel", engine_backend="fused",
                            device="cpu")
    params = params_from_numpy(numpy_params(
        {k: v.numpy() for k, v in d.items()}), "cpu", spec)
    z, t = d["t_z"], d["t_target"]

    def grads(p, new):
        return {f"{k}_{n}": (p[k][n] - v) / GRAD_LR for k, lv in new.items()
                for n, v in lv.items()}

    new, loss = make_train_step(model, lr=1e-2)(params, z, t)
    out["t_one_loss"] = loss
    out.update({f"t_one_{k}_{n}": v for k, lv in new.items()
                for n, v in lv.items()})
    gnew, _ = make_train_step(model, lr=GRAD_LR)(params, z, t)
    out.update({f"tg_one_{k}": v for k, v in grads(params, gnew).items()})
    for tag, m in meshes.items():
        step, specs = make_sharded_train_step(model, m, lr=1e-2)
        gstep, _ = make_sharded_train_step(model, m, lr=GRAD_LR)
        placed = place_params(params, m, specs)
        new, loss = step(placed, z, t)
        out[f"t_{tag}_loss"] = loss
        out.update({f"t_{tag}_{k}_{n}": v for k, lv in new.items()
                    for n, v in lv.items()})
        gnew, _ = gstep(placed, z, t)
        out.update({f"tg_{tag}_{k}": v
                    for k, v in grads(placed, gnew).items()})
        out.update({f"t_{tag}_{k}_{n}_spec": tuple(sp)
                    for k, lv in specs.items() for n, sp in lv.items()})
    return out


def server_worker(rank: int, world: int) -> dict:
    """One rank of a dp2 x mp2 ``GenServer`` on the reduced specs beside
    the one-process server (same seed): the largest difference per net,
    the cell key, cells built across a checkpoint swap, ``estimate_ms``
    and each engine's ``describe``."""
    import torch
    from repro_torch.launch.serve_gen import GenServer, reduced_specs

    specs = reduced_specs()
    nets = sorted(specs)
    ref = GenServer(nets=nets, specs=specs, backend="fused", seed=3,
                    device="cpu")
    srv = GenServer(nets=nets, specs=specs, backend="fused", seed=3,
                    device="cpu", dp=2, mp=2, dist_backend="gloo")
    out = {"diff": {}, "bucket3": srv.bucket(3), "buckets": srv.buckets()}
    for net in nets:
        zs = [r.latent for r in ref.random_requests(net, 3, seed=7)]
        y0 = ref.run_group(net, zs)
        y1 = srv.run_group(net, zs)
        out["diff"][net] = float(((y0 - y1).abs().max()
                                  / y0.abs().max().clamp_min(1)).item())
        out[f"shape_{net}"] = tuple(y1.shape)
        out[f"describe_{net}"] = srv.model(net)[0].engine.describe()
    net = "dcgan-dryrun"
    out["key"] = srv.cell_key(net, srv.bucket(3))
    n0 = srv.compile_count
    m, _ = srv.model(net)
    srv.swap_checkpoint(net, m.init(torch.Generator().manual_seed(99)))
    zs = [r.latent for r in srv.random_requests(net, 3, seed=11)]
    srv.run_group(net, zs)
    out["cells_before_swap"], out["cells_after_swap"] = (n0,
                                                         srv.compile_count)
    out["estimate_ms"] = srv.estimate_ms(net, srv.bucket(3))
    return out


def pretune_worker(rank: int, world: int, cache: str) -> dict:
    """One rank of a dp1 x mp2 fused engine on ``dcgan-dryrun`` pretuned
    at batch 2 on the CPU, ``autotune.measure`` replaced by a fake whose
    reading depends on the rank and the tile: every plan it times, the
    readings, the winners and ``estimate_ms``."""
    import os
    import zlib
    import torch
    from repro_torch.engine import SDEngine
    from repro_torch.kernels import autotune as A
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models.generative import GenerativeModel
    from repro_torch.sd import functional as sd_functional

    os.environ["REPRO_TORCH_SD_PLAN_CACHE"] = cache
    mesh = make_dev_mesh(1, 2, backend="gloo", device="cpu")
    seen, readings = [], {}
    real = sd_functional.execute

    def execute(plan, x):
        seen.append((plan, tuple(x.shape)))
        return real(plan, x)

    def measure(fn, iters=3, warmup=1, device=None):
        fn()
        plan, xs = seen[-1]
        ms = 1.0 + zlib.crc32(f"{plan.tile}/{rank}".encode()) % 997 / 997
        readings.setdefault((plan.cin, plan.backend), {})[str(plan.tile)] = ms
        return ms

    sd_functional.execute, A.measure = execute, measure
    spec = train_spec()
    eng = SDEngine(spec, backend="fused", device="cpu", mesh=mesh)
    eng.bind(GenerativeModel(spec, "native", device="cpu").init(
        torch.Generator().manual_seed(0)))
    tuned = eng.pretune([2], iters=1)
    groups = {eng.layer_geom(l, 2, algo=a).key():
              (l.cin, "winograd" if a else "fused")
              for l in spec.deconv_layers() for a in ("", "wino")}
    return {"timed": [(p.shards, p.cout, p.ws.shape[-1], p.bias.shape[0],
                       xs[0]) for p, xs in seen],
            "readings": readings,
            "winners": {groups[k]: str(p) for k, p in tuned.items()},
            "estimate_ms": eng.estimate_ms(2),
            "shards": {n: p.shards for n, p in eng.plans().items()}}


def blocked_worker(rank: int, world: int) -> dict:
    """A dp2 x mp2 rank with ``jax`` and ``repro`` made unimportable
    first: ``serve_gen --dryrun --dp 2 --mp 2`` on the CPU, one sharded
    train step on ``dcgan-dryrun`` and ``sd.execute_spmd``; returns the
    stats and any JAX module found loaded at the end."""
    import sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import torch
    from repro_torch import sd
    from repro_torch.launch import serve_gen
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.train_gen import (make_sharded_train_step,
                                              place_params)
    from repro_torch.models.generative import GenerativeModel

    _, stats = serve_gen.main(["--dryrun", "--device", "cpu", "--dp", "2",
                               "--mp", "2", "--dist-backend", "gloo",
                               "--backend", "fused"])
    mesh = make_dev_mesh(2, 2, backend="gloo", device="cpu")
    spec = train_spec()
    model = GenerativeModel(spec, "sd_kernel", engine_backend="fused",
                            device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    step, specs = make_sharded_train_step(model, mesh)
    z = torch.randn(4, spec.layers[0].cin,
                    generator=torch.Generator().manual_seed(1))
    t = torch.zeros(4, *spec.layers[-1].out_hw(), spec.layers[-1].cout)
    _, loss = step(place_params(params, mesh, specs), z, t)
    w, x = torch.ones(4, 4, 3, 8), torch.ones(4, 5, 6, 3)
    y = sd.execute_spmd(sd.plan(w.shape, 2, 1, backend="fused",
                                device="cpu").bind(w, mesh=mesh), x, mesh)
    bad = sorted(m for m in sys.modules
                 if (m == "jax" or m.startswith("jax.") or m == "repro"
                     or m.startswith("repro.")) and sys.modules[m] is not None)
    return {"served": stats["served"], "shed": stats["shed"],
            "loss": float(loss), "y": tuple(y.shape), "bad": bad}


def cuda_d1_worker(rank: int, world: int) -> dict:
    """One of two gloo ranks on ``cuda:0``: full-width DCGAN d1 (batch
    16, relu, folded scale and bias) bound Cout-sharded over a dp1 x mp2
    mesh through ``execute_spmd``, against the unsharded plan on the same
    card; K1's launches in the sharded call."""
    import torch
    import repro_torch.kernels.sd_conv as K
    from repro_torch import sd
    from repro_torch.core.accounting import WORKLOADS
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.launch.mesh import make_dev_mesh

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = make_dev_mesh(1, 2, backend="gloo", device=dev)
    l = WORKLOADS["dcgan"]().layers[1]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, *l.in_hw, l.cin, generator=g).to(dev)
    w = (torch.randn(l.k, l.k, l.cin, l.cout, generator=g)
         / (l.k * l.k * l.cin) ** 0.5).to(dev)
    scale = (1 + 0.1 * torch.randn(l.cout, generator=g)).to(dev)
    bias = (0.1 * torch.randn(l.cout, generator=g)).to(dev)
    p = sd.plan(w.shape, l.s, same_deconv_pads(l.k, l.s), backend="fused",
                act="relu", device=dev)
    ref = sd.execute(p.bind(w, scale, bias), x)
    bp = p.bind(w, scale, bias, mesh=mesh)
    K.SD_FUSED_LAUNCHES = 0
    y = sd.execute_spmd(bp, x, mesh)
    torch.cuda.synchronize()
    return {"launches": K.SD_FUSED_LAUNCHES, "local_cout": bp.cout_local,
            "d": (y - ref).abs().max().item(),
            "tol": 1e-5 * max(1.0, ref.abs().max().item()),
            "shape": tuple(y.shape), "ref_shape": tuple(ref.shape)}


def ckpt_worker(rank: int, world: int, path: str) -> dict:
    """One of two gloo ranks on the CPU: ``train_spec``'s params from
    :func:`make_inputs`, placed Cout-sharded on a dp1 x mp2 mesh, saved
    by ``CheckpointManager.save(mesh=, specs=)`` (gathered, rank 0
    writes); then restored by every rank unsharded, onto the mp2 mesh
    and onto a dp2 x mp1 mesh.  Returns each restored tree and
    ``place_params`` of the whole tree on both meshes, as numpy."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import MeshContext, gen_param_specs
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.train_gen import place_params

    spec = train_spec()
    whole = params_from_numpy(numpy_params(make_inputs()), "cpu", spec)
    meshes = {"mp2": make_dev_mesh(1, 2, backend="gloo", device="cpu"),
              "dp2": make_dev_mesh(2, 1, backend="gloo", device="cpu")}
    specs = {k: gen_param_specs(spec, MeshContext(m))
             for k, m in meshes.items()}
    mp2 = meshes["mp2"]
    placed = place_params(whole, mp2, specs["mp2"])
    mgr = CheckpointManager(path, keep=2)
    mgr.save(5, {"g": placed}, blocking=True, mesh=mp2,
             specs={"g": specs["mp2"]})
    mp2.barrier()                    # rank 0's write is committed
    out = {"steps": mgr.steps(), "whole": whole,
           "sharded_leaves": sorted(
               f"{k}/{n}" for k, v in specs["mp2"].items()
               for n, sp in v.items() if any(sp))}
    step, got = mgr.restore({"g": whole})
    out["restored"] = got["g"]
    for k, m in meshes.items():
        step, got = mgr.restore({"g": whole}, shardings=(m, {"g": specs[k]}))
        out[f"restored_{k}"] = got["g"]
        out[f"placed_{k}"] = place_params(whole, m, specs[k])
    out["step"] = step
    return out


def psum_worker(rank: int, world: int) -> dict:
    """One of two gloo ranks on the CPU: ``compressed_psum`` of this
    rank's vector over the data axis of a dp2 x mp1 mesh, through
    ``make_pod_compressed_allreduce``."""
    import torch
    from repro_torch.distributed.compress import make_pod_compressed_allreduce
    from repro_torch.launch.mesh import make_dev_mesh

    mesh = make_dev_mesh(2, 1, backend="gloo", device="cpu")
    xs = psum_inputs()
    f = make_pod_compressed_allreduce(mesh, (None,), axis="data")
    return {"out": f(torch.from_numpy(xs[rank]))}


def psum_inputs() -> list:
    """The two ranks' vectors of :func:`psum_worker`, numpy f32."""
    rng = np.random.RandomState(3)
    return [(rng.randn(257) * s).astype(np.float32) for s in (1.0, 3.0)]


def failing_worker(rank: int, world: int) -> int:
    """Rank 1 raises; rank 0 waits for it at a barrier."""
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()
    return rank


def hanging_worker(rank: int, world: int) -> int:
    """Rank 1 never returns within a test's deadline; rank 0 waits for
    it at a barrier (a collective that hangs)."""
    import time
    import torch.distributed as dist
    if rank == 1:
        time.sleep(120)
    dist.barrier()
    return rank
