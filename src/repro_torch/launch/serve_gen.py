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
cell key says ``int8``.  ``--nets`` takes any workload of
``core/accounting.py``; the 3-D ``voxgan`` runs each deconv layer as one
K2 launch per depth tap (K2's int8 pair under ``--dtype int8``).

  PYTHONPATH=src python -m repro_torch.launch.serve_gen --nets dcgan \\
      --requests 32 --max-batch 16
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --dryrun --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --dryrun \\
      --device cpu --backend winograd
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --dryrun \\
      --device cpu --dtype int8
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --nets voxgan \\
      --dtype int8
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.accounting import WORKLOADS, LayerSpec, NetworkSpec
from repro_torch.device import describe_device, resolve_device
from repro_torch.launch.batching import pow2_bucket, pow2_floor, take_group
from repro_torch.models.generative import GenerativeModel

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": "int8"}
_LATER = "not ported yet; see ROADMAP.md for the slice that brings it"


@dataclass
class GenRequest:
    """One inference request: a single un-batched generator input."""
    rid: int
    net: str
    latent: Any                 # shape == model.input_shape(1)[1:]


def reduced_specs() -> Dict[str, NetworkSpec]:
    """Tiny specs for ``--dryrun``: a 2-D generator, a 3-D voxel
    generator and a 2-D segmentation decoder with a mid-net conv and a
    logit head (the reference's set; its 1-D ``wavegan-dryrun`` comes
    with the rank-1 slice)."""
    return {
        "dcgan-dryrun": NetworkSpec("DCGAN-dryrun", [
            LayerSpec("fc", 16, 4 * 4 * 32, name="project"),
            LayerSpec("deconv", 32, 16, k=5, s=2, in_hw=(4, 4), name="d1"),
            LayerSpec("deconv", 16, 3, k=5, s=2, in_hw=(8, 8), name="d2"),
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
    so float and int8 cells of one ``(net, bucket)`` coexist."""

    def __init__(self, nets=("dcgan",), dtype=torch.float32,
                 backend: str = "auto", max_batch: int = 16, seed: int = 0,
                 specs: Optional[Dict[str, NetworkSpec]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.engine_dtype = "native"
        if dtype in ("int8", torch.int8):
            self.engine_dtype, dtype = "int8", torch.float32
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

    # ---- models and cells ------------------------------------------------
    def model(self, net: str) -> Tuple[GenerativeModel, Any]:
        """Bound (model, params) per net: the engine presplits here,
        once per server lifetime."""
        if net not in self._models:
            m = GenerativeModel(self._specs[net], deconv_impl="sd_kernel",
                                engine_backend=self.backend,
                                device=self.device,
                                engine_dtype=self.engine_dtype)
            gen = torch.Generator().manual_seed(self.seed)
            self._models[net] = (m, m.init(gen, dtype=self.dtype))
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
        """The closed pow2 ladder of batch buckets up to ``max_batch``."""
        out, n = [], 1
        while n <= self.max_batch:
            out.append(self.bucket(n))
            n *= 2
        return out

    def bucket(self, n: int) -> int:
        return pow2_bucket(n, self.max_batch)

    def cell_key(self, net: str, bucket: int) -> Tuple:
        return (net, bucket, self.dtype_name)

    def estimate_ms(self, net: str, bucket: int) -> Optional[float]:
        model, _ = self.model(net)
        return model.engine.estimate_ms(bucket)

    def compiled(self, net: str, bucket: int):
        """The callable of one serving cell ``(net, bucket, dtype)``:
        params and bound plans are its arguments, so a checkpoint swap
        reuses it.  Building a cell bumps ``compile_count``."""
        key = self.cell_key(net, bucket)
        if key not in self._compiled:
            model, _ = self.model(net)

            def cell(params, plans, x):
                with torch.no_grad():
                    return model.apply_with_plans(params, plans, x)

            self._compiled[key] = cell
            self.compile_count += 1
        return self._compiled[key]

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
        lean_params, plans = self._serving_args(net, bucket)
        x = torch.stack([torch.as_tensor(z) for z in latents]).to(
            self.device, self.dtype)
        if bucket > n:
            x = torch.cat([x, x.new_zeros((bucket - n, *x.shape[1:]))])
        return self.compiled(net, bucket)(lean_params, plans, x)[:n]

    def serve(self, requests: List[GenRequest]):
        """Drain loop: partition the queue into per-net groups and run
        them to completion.  Returns ({rid: output}, stats)."""
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
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--calib", type=int, default=0)
    ap.add_argument("--pretune", action="store_true")
    args = ap.parse_args(argv)
    for flag, later in (("--dp/--mp", args.dp != 1 or args.mp != 1),
                        ("--calib (the calibrated int8 chain)",
                         args.calib != 0),
                        ("--pretune", args.pretune)):
        if later:
            raise NotImplementedError(f"{flag}: {_LATER}")

    if args.dryrun:
        specs = reduced_specs()
        if args.backend == "winograd":
            # K4 covers rank 2 with taps <= 5: drop reduced specs outside
            # that envelope instead of failing the whole smoke.
            from repro_torch.kernels.winograd import supported
            specs = {n: sp for n, sp in specs.items()
                     if all(l.rank == 2 and supported((-(-l.k // l.s),) * 2)
                            for l in sp.deconv_layers())}
        nets = sorted(specs)
        n_requests = 2
        if args.deadline_ms is None:
            args.deadline_ms = 120_000.0     # exercised, never binding
    else:
        nets = args.nets.split(",")
        specs = None
        n_requests = args.requests

    server = GenServer(nets=nets, dtype=DTYPES[args.dtype],
                       backend=args.backend, max_batch=args.max_batch,
                       specs=specs, device=args.device)
    requests: List[GenRequest] = []
    for i, net in enumerate(nets):
        for r in server.random_requests(net, n_requests, seed=i + 1):
            r.rid = len(requests)
            requests.append(r)

    where = describe_device(server.device)
    if args.sched == "async":
        results, stats = serve_async(server, requests,
                                     deadline_ms=args.deadline_ms)
        print(f"served {stats['requests']} requests in "
              f"{stats['wall_s']:.3f}s ({stats['req_per_s']:.1f} req/s, "
              f"{stats['launches']} launches, {stats['compiles']} cells "
              f"built, {stats['shed']} shed) on {where}")
        lat = stats["latency_ms"]
        print(f"  latency p50 {lat['p50']}ms p95 {lat['p95']}ms "
              f"p99 {lat['p99']}ms; mean occupancy "
              f"{stats['mean_occupancy']} on {where}")
    else:
        results, stats = server.serve(requests)
        print(f"served {stats['requests']} requests in "
              f"{stats['wall_s']:.3f}s ({stats['req_per_s']:.1f} req/s, "
              f"{stats['groups']} groups, {stats['compiles']} cells "
              f"built) on {where}")
    for key in stats["compile_cache"]:
        print(f"  cell: {key}")
    for rid in sorted(results)[:2]:
        out = results[rid].float().cpu()
        print(f"  req{rid}: out{tuple(out.shape)} mean {out.mean():+.4f}")
    return results, stats


if __name__ == "__main__":
    main()
