"""Meshes over ``torch.distributed`` and the launcher of their ranks.

The role of the reference's ``repro.launch.mesh``: every mesh of the
generative stack (the server's under ``--dp/--mp``, the sharded train
step's, the tests') comes from :func:`make_dev_mesh`, which runs over an
initialised default process group of ``n_data * n_model`` ranks and
returns this rank's :class:`~repro_torch.distributed.Mesh` (with a
``'pod'`` axis ahead where ``n_pod > 1``); :func:`make_production_mesh`
is the reference's 16 x 16 and 2 x 16 x 16 layout, for the dry-run.  The caller
names the transport (``"nccl"`` or ``"gloo"``) and the device; nothing
here picks either on its own.  :func:`spawn` starts ``world`` ranks on
this host with a ``file://`` store in a temporary directory, each with a
timeout on every collective, and fails when a rank fails or outlives its
deadline.

    from repro_torch.launch.mesh import make_dev_mesh, spawn

    def work(rank, world):
        mesh = make_dev_mesh(1, 2, backend="gloo", device="cpu")
        ...                                  # return numpy, not tensors

    results = spawn(work, 2, backend="gloo")     # [rank 0's, rank 1's]

On one card the ranks are gloo processes that share ``cuda:0`` (NCCL
refuses two ranks on one device); a gather then is a host copy, not a
link between cards.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import Mesh

BACKENDS = ("gloo", "nccl")
TIMEOUT_S = 300.0      # every collective of a spawned rank, and its life
GRACE_S = 5.0          # after a rank fails, for the others' reports


def _check_backend(backend: Optional[str]) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"name the process group's backend: one of "
                         f"{BACKENDS}, not {backend!r}")
    return backend


def make_dev_mesh(n_data: int = 1, n_model: int = 1, *,
                  backend: str, device: DeviceLike, n_pod: int = 1,
                  timeout_s: float = TIMEOUT_S) -> Mesh:
    """This rank's (data, model) mesh over the default process group,
    whose world size must be ``n_pod * n_data * n_model`` (the reference
    checks the device count the same way); ``n_pod > 1`` adds the
    outermost ``'pod'`` axis of the production two-pod mesh.  Makes one
    process group per line of the row-major grid along each axis of
    size > 1 (the model axis: ranks that share their pod and data
    indices; the data axis; the pod axis); every rank of the world must
    call this, in the same order, as ``torch.distributed.new_group``
    requires.  ``backend`` and ``device`` are the caller's; nothing here
    changes them."""
    import torch.distributed as dist
    _check_backend(backend)
    pod, dp, mp = int(n_pod), int(n_data), int(n_model)
    if pod < 1 or dp < 1 or mp < 1:
        raise ValueError(f"mesh degrees must be >= 1, got pod {pod} dp {dp} "
                         f"mp {mp}")
    shape = f"{'pod%dx' % pod if pod > 1 else ''}dp{dp}xmp{mp}"
    n = pod * dp * mp
    if not dist.is_initialized():
        raise ValueError(
            f"a {shape} mesh needs {n} ranks in an initialised "
            "torch.distributed process group; start them with "
            "repro_torch.launch.mesh.spawn (or torchrun) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {world}")
    dev = resolve_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = {}

    def at(p, d, m):
        return (p * dp + d) * mp + m
    lines = {
        "model": [[at(p, d, m) for m in range(mp)]
                  for p in range(pod) for d in range(dp)],
        "data": [[at(p, d, m) for d in range(dp)]
                 for p in range(pod) for m in range(mp)],
        "pod": [[at(p, d, m) for p in range(pod)]
                for d in range(dp) for m in range(mp)]}
    for axis, blocks in lines.items():
        if len(blocks[0]) == 1:
            continue
        for ranks in blocks:
            g = dist.new_group(ranks, timeout=timeout, backend=backend)
            if rank in ranks:
                groups[axis] = g
    return Mesh(dp, mp, rank=rank, backend=backend, device=dev,
                groups=groups, pod=pod)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """The reference's production topology as a layout for ``rank``: 16 x
    16 over ``('data', 'model')`` (one pod, 256 cards), or 2 x 16 x 16
    over ``('pod', 'data', 'model')`` (two pods, 512), row-major as
    ``jax.make_mesh`` orders them.  It touches no device and no process
    group: the dry-run (:mod:`repro_torch.launch.dryrun`) runs a rank's
    step on it with an abstract transport."""
    if not 0 <= rank < (512 if multi_pod else 256):
        raise ValueError(f"rank {rank} is not on the "
                         f"{'2x16x16' if multi_pod else '16x16'} mesh")
    return Mesh(16, 16, rank=rank, pod=2 if multi_pod else 1)


def _to_host(obj):
    """Tensors in ``obj`` as numpy arrays: a rank's result crosses the
    process boundary by pickle, never by shared memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, world: int, backend: str, store: str,
               timeout_s: float, fn: Callable, args: Sequence, results):
    import torch.distributed as dist
    ok = False
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        out, ok = _to_host(fn(rank, world, *args)), True
    except BaseException:            # reported to the parent, then exit 1
        out = traceback.format_exc()
    # report before the group goes: its peers fail once it is gone
    results.put((rank, ok, out))
    if dist.is_initialized():
        dist.destroy_process_group()
    if not ok:
        raise SystemExit(1)


def spawn(fn: Callable, world: int, *, backend: str,
          args: Sequence[Any] = (), timeout_s: float = TIMEOUT_S
          ) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes that
    form one process group on ``backend`` through a ``file://`` store
    in a temporary directory; returns each rank's result, rank order,
    its tensors as numpy arrays.  ``fn`` must be importable by name (a
    module-level function).  Every collective carries ``timeout_s``, and
    so does the whole run: a rank that raises, dies or is still running
    at the deadline fails the call (``RuntimeError``), and every rank
    still alive is then ended."""
    import multiprocessing as mp
    _check_backend(backend)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, os.path.join(tmp, "store"),
                               timeout_s, fn, tuple(args), results),
                         daemon=False)
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    got, errors, started, reported = {}, [], [], set()
    try:
        for p in procs:
            p.start()
            started.append(p)
        while len(reported) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                if not errors:
                    errors.append(f"ranks {sorted(set(range(world)) - reported)}"
                                  f" still running after {timeout_s:.0f} s")
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in reported]
                if dead and not errors:
                    errors.append(f"rank {dead[0]} exited with code "
                                  f"{procs[dead[0]].exitcode} before it "
                                  "reported")
                    deadline = min(deadline, time.monotonic() + GRACE_S)
                continue
            reported.add(rank)
            if ok:
                got[rank] = out
            else:
                # the first failure ends its peers' collectives: give
                # their reports a moment, so that every cause is shown
                errors.append(f"rank {rank} failed:\n{out}")
                deadline = min(deadline, time.monotonic() + GRACE_S)
    finally:
        for p in started:
            if (errors or len(started) < world) and p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError(f"spawn of {world} {backend} ranks failed: "
                           + "\n".join(errors))
    return [got[r] for r in range(world)]
