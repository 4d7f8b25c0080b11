"""Batched generative-network serving on the SD inference engine.

The server groups queued requests by network, pads each group's batch
up to a power-of-two *bucket*, and runs the bucket through an
:class:`~repro_torch.engine.SDEngine`-backed model whose filters were
split and BN-folded once at bind.  A serving *cell* is one ``(net,
bucket, dtype)`` entry; ``compile_count`` counts cells built, and the
async scheduler asserts that no launch into an existing cell builds it
again (checkpoint swaps included).

Two loops share this machinery: the async continuous-batching scheduler
(:mod:`repro_torch.serving`, the default) and the drain loop
(:meth:`GenServer.serve`, ``--sched drain``).  Runs on the card unless
``--device cpu`` is given.  ``--backend winograd`` serves every deconv
layer on K4, the Winograd kernel (one server has one backend, so the
cell key does not name it).  ``--dtype int8`` serves through int8
engine plans (per-channel filter quantization at bind, per-sample
activation quantization and the dequant epilogue on the hot path, K1's
int8 branch on ``fused``); latents, params and outputs stay f32 and the
cell key says ``int8``.  ``--calib N`` (with ``--dtype int8``) first
calibrates each net on N latents: static activation scales replace the
per-sample quantization, and consecutive deconv layers pass int8 codes
(K1's int8 output); the scales are saved under ``"<net>/max"`` in
``$REPRO_TORCH_SD_CALIB_CACHE`` (default
``~/.cache/repro_torch/sd_calib.json``).  ``--nets`` takes any workload of
``core/accounting.py``; the 1-D ``wavegan`` runs each deconv layer as
an H=1 launch of K1 (or K1's int8 branch), the 3-D ``voxgan`` as one K2
launch per depth tap (K2's int8 pair under ``--dtype int8``).

  PYTHONPATH=src python -m repro_torch.launch.serve_gen --nets dcgan \\
      --requests 32 --max-batch 16
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --dryrun --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --dryrun \\
      --device cpu --backend winograd
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --dryrun \\
      --device cpu --dtype int8
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --nets voxgan \\
      --dtype int8
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --nets wavegan \\
      --dtype int8 --calib 64
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --dtype int8 \\
      --calib 64

``--dp N --mp M --dist-backend gloo|nccl`` serves on a (data, model)
mesh of ``N * M`` ranks (reference ``--dp/--mp``), one process per rank
in a process group of that size (:func:`repro_torch.launch.mesh.spawn`,
or torchrun): each batch splits over ``'data'``, each deconv layer whose
``cout`` divides ``M`` runs its Cout block on each ``'model'`` rank and
gathers the channel axis; every rank runs the same requests and gets
every output, and rank 0 prints.  The bucket rounds up to a multiple of
``N`` and the cell key ends in ``dpNxmpM``.  On the CPU:

  PYTHONPATH=src python -c "from repro_torch.launch import mesh, serve_gen
  mesh.spawn(serve_gen.spmd_main, 4, backend='gloo', args=(['--dryrun',
  '--device', 'cpu', '--dp', '2', '--mp', '2', '--dist-backend',
  'gloo'],))"

``--pretune`` first times every (deconv layer, bucket) launch's
candidate tiles (K1's, and on a float ``fused`` server K4's too) and
caches the fastest in ``$REPRO_TORCH_SD_PLAN_CACHE`` (default
``~/.cache/repro_torch/sd_plans.json``); the server then launches the
measured tiles, runs each layer on whichever of K1 and K4 measured
faster, and seeds the scheduler's admission control with the summed
times.  On the CPU the kernels' plain versions run, so the tiles steer
nothing there:

  REPRO_TORCH_SD_PLAN_CACHE="${TMPDIR:-/tmp}/sd_plans.$$.json" \\
      PYTHONPATH=src python -m repro_torch.launch.serve_gen --dryrun \\
      --device cpu --backend fused --pretune
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.accounting import WORKLOADS, LayerSpec, NetworkSpec
from repro_torch.device import describe_device, resolve_device
from repro_torch.distributed.sharding import spmd
from repro_torch.launch.batching import pow2_bucket, pow2_floor, take_group
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models.generative import GenerativeModel

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": "int8"}


@dataclass
class GenRequest:
    """One inference request: a single un-batched generator input."""
    rid: int
    net: str
    latent: Any                 # shape == model.input_shape(1)[1:]


def reduced_specs() -> Dict[str, NetworkSpec]:
    """Tiny specs for ``--dryrun``, one per workload family (the
    reference's set): a 2-D generator, a 1-D audio generator, a 3-D
    voxel generator and a 2-D segmentation decoder with a mid-net conv
    and a logit head."""
    return {
        "dcgan-dryrun": NetworkSpec("DCGAN-dryrun", [
            LayerSpec("fc", 16, 4 * 4 * 32, name="project"),
            LayerSpec("deconv", 32, 16, k=5, s=2, in_hw=(4, 4), name="d1"),
            LayerSpec("deconv", 16, 3, k=5, s=2, in_hw=(8, 8), name="d2"),
        ]),
        "wavegan-dryrun": NetworkSpec("WaveGAN-dryrun", [
            LayerSpec("fc", 8, 8 * 8, name="project"),
            LayerSpec("deconv", 8, 4, k=9, s=2, in_hw=(8,), name="up1"),
            LayerSpec("deconv", 4, 1, k=9, s=2, in_hw=(16,),
                      name="to_audio"),
        ]),
        "voxgan-dryrun": NetworkSpec("VoxGAN-dryrun", [
            LayerSpec("fc", 8, 2 ** 3 * 8, name="project"),
            LayerSpec("deconv", 8, 4, k=4, s=2, in_hw=(2, 2, 2),
                      name="up1"),
            LayerSpec("deconv", 4, 1, k=4, s=2, in_hw=(4, 4, 4),
                      name="to_vox"),
        ]),
        "segnet-dryrun": NetworkSpec("SegNet-dryrun", [
            LayerSpec("conv", 3, 8, k=3, s=2, in_hw=(8, 8), name="e1"),
            LayerSpec("deconv", 8, 4, k=4, s=2, in_hw=(4, 4), name="d1"),
            LayerSpec("conv", 4, 3, k=3, s=1, in_hw=(8, 8),
                      name="logits"),
        ], final_tanh=False),
    }


class GenServer:
    """Slot-based batched generative inference service on SDEngine.

    ``dtype="int8"`` selects the int8 serving path: the engines bind int8
    plans while latents, params and outputs stay f32 (int8 is an
    execution dtype, not an IO dtype), and the cell key says ``int8``,
    so float and int8 cells of one ``(net, bucket)`` coexist.

    ``calib=N`` (int8 only) calibrates each net once, on N latents from
    the server's seed, when the net's model is built and before any of
    its cells runs; the scales are saved under ``"<net>/max"`` in the
    port's calibration cache (``core.quant.calib_cache_path``).

    ``dp``/``mp`` serve on a (data, model) mesh (reference
    ``GenServer(dp=, mp=)``): the default process group must hold ``dp *
    mp`` ranks (else ``ValueError``, as the reference raises on too few
    devices) and ``dist_backend`` names its transport.  Each rank builds
    the same models from the same seed; the engines keep each rank's
    Cout block of the layers that shard (:class:`~repro_torch.engine.
    SDEngine` ``mesh=``).  A cell runs the rank's ``'data'`` block of
    the bucket under :func:`~repro_torch.distributed.spmd` and gathers
    the batch; every rank must launch the same groups (:meth:`agree`
    checks the requests once per run and refuses deadlines), so every
    rank gets every output."""

    def __init__(self, nets=("dcgan",), dtype=torch.float32,
                 backend: str = "auto", max_batch: int = 16, seed: int = 0,
                 specs: Optional[Dict[str, NetworkSpec]] = None,
                 device=None, calib: int = 0, dp: int = 1, mp: int = 1,
                 dist_backend: Optional[str] = None):
        self.device = resolve_device(device)
        self.engine_dtype = "native"
        if dtype in ("int8", torch.int8):
            self.engine_dtype, dtype = "int8", torch.float32
        self.calib = int(calib)
        if self.calib and self.engine_dtype != "int8":
            raise ValueError("calib applies to int8 serving only")
        self.dtype = dtype
        self.dtype_name = ("int8" if self.engine_dtype == "int8"
                           else str(dtype).replace("torch.", ""))
        self.backend = backend
        # The cap is also the group-size bound, so it must itself be a
        # power of two (else a full group would overflow its bucket).
        self.max_batch = pow2_floor(max(1, int(max_batch)))
        self.seed = seed
        self._specs = dict(specs or {})
        for n in nets:
            if n not in self._specs:
                self._specs[n] = WORKLOADS[n]()
        self._models: Dict[str, Tuple[GenerativeModel, Any]] = {}
        self._serving: Dict[Tuple, Tuple[Any, Any, Any]] = {}
        self._compiled: Dict[Tuple, Any] = {}
        self.compile_count = 0          # serving cells built
        self.dp, self.mp = int(dp), int(mp)
        self._mesh = None
        if self.dp > 1 or self.mp > 1:
            self._mesh = make_dev_mesh(self.dp, self.mp,
                                       backend=dist_backend,
                                       device=self.device)

    @property
    def mesh(self):
        return self._mesh

    @property
    def rank(self) -> int:
        return 0 if self._mesh is None else self._mesh.rank

    # ---- models and cells ------------------------------------------------
    def model(self, net: str) -> Tuple[GenerativeModel, Any]:
        """Bound (model, params) per net: the engine presplits here,
        once per server lifetime."""
        if net not in self._models:
            m = GenerativeModel(self._specs[net], deconv_impl="sd_kernel",
                                engine_backend=self.backend,
                                device=self.device,
                                engine_dtype=self.engine_dtype,
                                engine_mesh=self._mesh)
            gen = torch.Generator().manual_seed(self.seed)
            params = m.init(gen, dtype=self.dtype)
            if self.calib > 0:
                # every rank calibrates the same way; rank 0 saves
                m.calibrate(params, n=self.calib, seed=self.seed,
                            save_key=f"{net}/max" if self.rank == 0
                            else None)
            self._models[net] = (m, params)
        return self._models[net]

    def _serving_args(self, net: str, bucket: int):
        """(non-deconv params, bound plans) for one cell, cached per
        (net, bucket).  The engine is first made to hold plans split from
        the live params in their current state (``bound_to`` compares
        identity and ``_version``, so an in-place update rebinds); the
        snapshot is keyed on the params object and on the engine's plan
        generation, so it follows every rebind."""
        model, params = self.model(net)
        engine = model.engine
        if not engine.bound_to(params):
            engine.bind(params)
        key = (net, bucket)
        cached = self._serving.get(key)
        if (cached is None or cached[0] is not params
                or cached[1] != engine.generation):
            deconv = {l.name for l in model.spec.deconv_layers()}
            lean = {k: v for k, v in params.items() if k not in deconv}
            self._serving[key] = (params, engine.generation, lean,
                                  engine.plans_for_batch(bucket))
        _, _, lean, plans = self._serving[key]
        return lean, plans

    def buckets(self) -> List[int]:
        """The closed set of batch buckets: the pow2 ladder up to
        ``max_batch``, each rounded up to a multiple of ``dp``."""
        out, n = [], 1
        while n <= self.max_batch:
            b = self.bucket(n)
            if b not in out:
                out.append(b)
            n *= 2
        return out

    def bucket(self, n: int) -> int:
        b = pow2_bucket(n, self.max_batch)
        if self.dp > 1:
            # each data rank runs bucket / dp rows: round up to a multiple
            b = -(-max(b, self.dp) // self.dp) * self.dp
        return b

    def cell_key(self, net: str, bucket: int) -> Tuple:
        """``(net, bucket, dtype)``; on a mesh the mesh's shape
        ``dpNxmpM`` ends the key: the same (net, bucket) on another mesh
        is another cell."""
        if self._mesh is None:
            return (net, bucket, self.dtype_name)
        return (net, bucket, self.dtype_name, f"dp{self.dp}xmp{self.mp}")

    def estimate_ms(self, net: str, bucket: int) -> Optional[float]:
        """The engine's summed measured ms at ``bucket``, keyed on what
        one rank launches on a mesh (its batch block, its Cout block)."""
        model, _ = self.model(net)
        return model.engine.estimate_ms(bucket)

    def compiled(self, net: str, bucket: int):
        """The callable of one serving cell (:meth:`cell_key`): params
        and bound plans are its arguments, so a checkpoint swap reuses
        it.  On a mesh it runs the rank's ``'data'`` block of the bucket
        under :func:`~repro_torch.distributed.spmd` (the sharded layers
        gather their channels) and gathers the batch over ``'data'``.
        Building a cell bumps ``compile_count``."""
        key = self.cell_key(net, bucket)
        if key not in self._compiled:
            model, _ = self.model(net)
            mesh = self._mesh

            def cell(params, plans, x):
                with torch.no_grad():
                    if mesh is None:
                        return model.apply_with_plans(params, plans, x)
                    bl = x.shape[0] // self.dp
                    xl = x.narrow(0, mesh.data_index * bl, bl)
                    with spmd(mesh):
                        y = model.apply_with_plans(params, plans, xl)
                    return mesh.all_gather(y, "data", 0)

            self._compiled[key] = cell
            self.compile_count += 1
        return self._compiled[key]

    def pretune(self, iters: int = 3) -> Dict[str, Any]:
        """Time and cache the tiles of every (deconv layer, bucket)
        launch this server will run (``serve_gen --pretune``; reference
        ``GenServer.pretune``): each net's engine pretunes at every bucket
        of :meth:`buckets`, and a float ``fused`` engine binds the layers
        where K4 measured faster to it.  ``{}`` on the ``torch`` backend.
        Returns ``{geometry key: winning plan}``."""
        tuned: Dict[str, Any] = {}
        buckets = self.buckets()
        for net in self._specs:
            model, _ = self.model(net)
            if model.engine is not None:
                tuned.update(model.engine.pretune(buckets, iters=iters))
        return tuned

    def warmup(self, nets: Optional[List[str]] = None) -> int:
        """Build every cell of the bucket ladder and run it once through
        :meth:`run_group` — the serving path itself, with the smallest
        group of each bucket so the padding runs too — so that no live
        request pays a first use (a cell, or a kernel the device loads
        lazily).  Returns the number of cells built."""
        before = self.compile_count
        for net in (nets if nets is not None else list(self._specs)):
            model, _ = self.model(net)
            z = torch.zeros(model.input_shape(1)[1:], dtype=self.dtype,
                            device=self.device)
            for b in self.buckets():
                self.run_group(net, [z] * (b // 2 + 1 if b > 1 else 1))
        self._sync()
        return self.compile_count - before

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- live checkpoint hot-swap ---------------------------------------
    def swap_checkpoint(self, net: str, params) -> None:
        """Rebind ``net`` to a new parameter set: the engine re-splits
        the new filters; every cell is reused as is."""
        model, _ = self.model(net)
        model.engine.bind(params)
        self._models[net] = (model, params)

    # ---- serving ---------------------------------------------------------
    def run_group(self, net: str, latents: List[Any]) -> torch.Tensor:
        """Pad a same-net group to its bucket, run, crop the padding."""
        n = len(latents)
        bucket = self.bucket(n)
        if self._mesh is not None:
            self._mesh.check_same(f"the launch of {net!r}",
                                  [sorted(self._specs).index(net), n])
        lean_params, plans = self._serving_args(net, bucket)
        x = torch.stack([torch.as_tensor(z) for z in latents]).to(
            self.device, self.dtype)
        if bucket > n:
            x = torch.cat([x, x.new_zeros((bucket - n, *x.shape[1:]))])
        return self.compiled(net, bucket)(lean_params, plans, x)[:n]

    def agree(self, requests: List[GenRequest],
              deadline_ms: Optional[float] = None) -> None:
        """On a mesh, once per run: raise unless every rank holds the same
        requests (ids and nets, in order), so that every rank groups them
        alike, and refuse deadlines, by which each rank would shed on its
        own clock and launch groups its peers do not.  Nothing to agree
        on without a mesh."""
        if self._mesh is None:
            return
        if deadline_ms is not None:
            raise ValueError("deadline_ms on a mesh server: each rank would "
                             "shed by its own clock and launch groups its "
                             "peers do not; serve a mesh without deadlines")
        nets = sorted(self._specs)
        self._mesh.check_same("the requests", [len(requests)] + [
            v for r in requests for v in (r.rid, nets.index(r.net))])

    def serve(self, requests: List[GenRequest]):
        """Drain loop: partition the queue into per-net groups and run
        them to completion.  Returns ({rid: output}, stats)."""
        self.agree(requests)
        queue = list(requests)
        results: Dict[int, Any] = {}
        t0 = time.perf_counter()
        groups = samples = 0
        while queue:
            group, queue = take_group(queue, lambda r: r.net,
                                      self.max_batch)
            out = self.run_group(group[0].net, [r.latent for r in group])
            self._sync()
            for r, img in zip(group, out):
                results[r.rid] = img
            groups += 1
            samples += len(group)
        dt = time.perf_counter() - t0
        return results, {
            "wall_s": dt, "groups": groups, "requests": samples,
            "req_per_s": samples / dt if dt else float("inf"),
            "compiles": self.compile_count,
            "compile_cache": sorted(str(k) for k in self._compiled),
        }

    def random_requests(self, net: str, n: int, seed: int = 1
                        ) -> List[GenRequest]:
        """``n`` unit-normal latents from a seeded CPU generator, on the
        server's device."""
        model, _ = self.model(net)
        gen = torch.Generator().manual_seed(seed)
        z = torch.randn(model.input_shape(n), generator=gen).to(
            self.device, self.dtype)
        return [GenRequest(rid=i, net=net, latent=z[i]) for i in range(n)]


def serve_async(server: GenServer, requests: List[GenRequest],
                deadline_ms: Optional[float] = None):
    """Run ``requests`` through the continuous-batching scheduler (all
    arrive at t0).  Returns ({rid: output}, stats) like
    :meth:`GenServer.serve`."""
    from repro_torch.serving import ContinuousScheduler
    server.agree(requests, deadline_ms)
    sched = ContinuousScheduler(server)
    t0 = sched.clock.now()
    for r in requests:
        sched.submit(r.net, r.latent, rid=r.rid, arrival_t=t0,
                     deadline_ms=deadline_ms)
    results = sched.run()
    wall = sched.clock.now() - t0
    stats = sched.stats(wall_s=wall)
    stats["wall_s"] = wall
    stats["requests"] = stats["served"]
    stats["req_per_s"] = stats["served"] / wall if wall else float("inf")
    return results, stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve the paper's generators through the port.")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--nets", default="dcgan",
                    help=f"comma list from {tuple(WORKLOADS)}")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "fused", "torch", "winograd"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--sched", default="async", choices=["async", "drain"])
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; the async scheduler sheds "
                         "requests it cannot meet")
    ap.add_argument("--dryrun", action="store_true",
                    help="2 requests per reduced spec (smoke test)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree: the batch splits over dp "
                         "ranks (needs dp*mp ranks in the process group)")
    ap.add_argument("--mp", type=int, default=1,
                    help="model-parallel degree: each deconv layer whose "
                         "cout divides mp runs its Cout block per rank")
    ap.add_argument("--dist-backend", default=None,
                    choices=["gloo", "nccl"],
                    help="the process group's transport under --dp/--mp "
                         "(gloo for ranks that share one card or the CPU)")
    ap.add_argument("--calib", type=int, default=0, metavar="N",
                    help="int8 only: calibrate static activation scales "
                         "on N latents per net and chain int8 activations "
                         "between consecutive deconv layers (0 = dynamic "
                         "per-sample scales)")
    ap.add_argument("--pretune", action="store_true",
                    help="before serving, time the candidate tiles of every "
                         "(deconv layer, bucket) launch and cache the "
                         "fastest in $REPRO_TORCH_SD_PLAN_CACHE; a fused "
                         "server then runs each layer on K1 or K4, "
                         "whichever measured faster")
    args = ap.parse_args(argv)
    if args.calib and args.dtype != "int8":
        ap.error("--calib requires --dtype int8")
    if args.deadline_ms is not None and args.dp * args.mp > 1:
        ap.error("--deadline-ms needs one process: on a --dp/--mp mesh "
                 "each rank would shed by its own clock")

    if args.dryrun:
        specs = reduced_specs()
        if args.backend == "winograd":
            # K4 covers ranks 1-2 with taps <= 5: drop reduced specs
            # outside that envelope (the 3-D voxel smoke) instead of
            # failing the whole smoke.
            from repro_torch.kernels.winograd import supported
            specs = {n: sp for n, sp in specs.items()
                     if all(supported((-(-l.k // l.s),) * l.rank)
                            for l in sp.deconv_layers())}
        nets = sorted(specs)
        n_requests = 2
        if args.deadline_ms is None and args.dp * args.mp == 1:
            args.deadline_ms = 120_000.0     # exercised, never binding
    else:
        nets = args.nets.split(",")
        specs = None
        n_requests = args.requests

    server = GenServer(nets=nets, dtype=DTYPES[args.dtype],
                       backend=args.backend, max_batch=args.max_batch,
                       specs=specs, device=args.device, calib=args.calib,
                       dp=args.dp, mp=args.mp,
                       dist_backend=args.dist_backend)
    say = print if server.rank == 0 else (lambda *a, **k: None)
    if args.pretune:
        t0 = time.perf_counter()
        tuned = server.pretune()
        say(f"pretuned {len(tuned)} (layer, bucket) geometries over "
            f"buckets {server.buckets()} in "
            f"{time.perf_counter() - t0:.1f} s")
    requests: List[GenRequest] = []
    for i, net in enumerate(nets):
        for r in server.random_requests(net, n_requests, seed=i + 1):
            r.rid = len(requests)
            requests.append(r)

    where = describe_device(server.device)
    if server.mesh is not None:
        where += (f", mesh dp{server.dp}xmp{server.mp} of "
                  f"{args.dist_backend} ranks")
    if args.sched == "async":
        results, stats = serve_async(server, requests,
                                     deadline_ms=args.deadline_ms)
        say(f"served {stats['requests']} requests in "
              f"{stats['wall_s']:.3f}s ({stats['req_per_s']:.1f} req/s, "
              f"{stats['launches']} launches, {stats['compiles']} cells "
              f"built, {stats['shed']} shed) on {where}")
        lat = stats["latency_ms"]
        say(f"  latency p50 {lat['p50']}ms p95 {lat['p95']}ms "
              f"p99 {lat['p99']}ms; mean occupancy "
              f"{stats['mean_occupancy']} on {where}")
    else:
        results, stats = server.serve(requests)
        say(f"served {stats['requests']} requests in "
              f"{stats['wall_s']:.3f}s ({stats['req_per_s']:.1f} req/s, "
              f"{stats['groups']} groups, {stats['compiles']} cells "
              f"built) on {where}")
    for key in stats["compile_cache"]:
        say(f"  cell: {key}")
    for rid in sorted(results)[:2]:
        out = results[rid].float().cpu()
        say(f"  req{rid}: out{tuple(out.shape)} mean {out.mean():+.4f}")
    return results, stats


def spmd_main(rank: int, world: int, argv: List[str]) -> dict:
    """One rank of :func:`main` under :func:`repro_torch.launch.mesh.
    spawn`: its stats (served, shed, launches, cells)."""
    _, stats = main(argv)
    return {k: stats[k] for k in ("served", "shed", "launches",
                                  "compile_cache") if k in stats}


if __name__ == "__main__":
    main()
