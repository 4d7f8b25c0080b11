"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``repro_torch`` only (never JAX, never the JAX package ``repro``):

1. builds the fused split-deconv kernel (K1, ``src/repro_torch/kernels/
   csrc/sd_fused.cu``) with nvcc for sm_90a and prints its registers and
   shared memory;
2. holds K1 against its plain PyTorch version ``sd_fused_ref`` on the 22
   deconv layers of the paper's six networks (batch 4, f32, TF32 off,
   ``max|d| <= 1e-4 * max(1, max|y_ref|)``), on an ``output_padding >
   pad_hi`` geometry and a many-tile geometry, then on DCGAN's three
   layers in bf16 (``<= 1e-2 * max|y_ref|``); times K1, the plain version
   and ``F.conv_transpose2d`` (cuDNN, a yardstick the port never calls)
   per DCGAN layer at the serving bucket 16;
3. serves 48 full-width DCGAN requests through ``GenServer`` on the card
   with the async scheduler, and checks that every batch ran K1 once per
   deconv layer, that every output is finite, and that it matches the
   same model on the plain ``torch`` backend (and, for two requests, the
   ``native`` model on the CPU);
4. runs each of the six paper networks once at batch 1 through K1
   against the plain backend.

Every printed number carries the card's name and power limit.  The line
before the last is ``{"kernels": [...]}``; the last is ``{"ok": true,
"device": {...}}``.  Exits non-zero, with no result, when CUDA is absent
or the repository's ``src/repro_torch`` is not beside this file.

    python3 chip_smoke.py [--json report.json]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TIME_LIMIT_S = 1200
F32_GATE = 1e-4          # relative to max(1, max|y_ref|)
BF16_GATE = 1e-2         # relative to max|y_ref|
PEAK_F32_FLOPS = 67e12   # H100 SXM, CUDA cores, dense (data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
SERVE_REQUESTS = 48
BUCKET = 16
SEED = 0


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fns: dict, reps: int = 7, iters: int = 20) -> dict:
    """Device time of each ``fns[name]()`` in ms: CUDA events around
    ``iters`` warm launches, repeated ``reps`` times in turns (the order
    reversed every other round) so that a slow spell of the card hits
    every function alike.  Returns ``{name: (median, min, max)}``."""
    import torch
    names = list(fns)
    for name in names:
        for _ in range(3):
            fns[name]()
    runs = {name: [] for name in names}
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            runs[name].append(start.elapsed_time(end) / iters)
    return {name: (sorted(v)[len(v) // 2], min(v), max(v))
            for name, v in runs.items()}


def _clocks() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def _device_breakdown(fn):
    """One synchronised call of ``fn`` under ``torch.profiler``: (device
    busy ms, wall ms, [(kernel, ms, calls)] top 6 by device time), or
    None when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue                      # host ops: their kernels count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), wall, rows[:6]


def _gate_err(out, ref, rel: float, floor_one: bool) -> tuple:
    d = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = rel * (max(1.0, scale) if floor_one else scale)
    return d, tol


def main(json_path: str = "") -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 3
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch.nn.functional as F
    import repro_torch.kernels.sd_conv as K
    from repro_torch import sd
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.accounting import BENCHMARKS
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import (FusedGeom, KernelPlan,
                                              smem_bytes)
    from repro_torch.kernels.build import build
    from repro_torch.launch.serve_gen import GenServer, serve_async
    from repro_torch.models.generative import GenerativeModel, build as mk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card_line()
    tag = f"[{card}]"
    print(f"device: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s) visible")

    # ---- 1. build ------------------------------------------------------
    built = build(["sd_fused"])["sd_fused"]
    print(f"build: nvcc sd_fused.cu for sm_90a in {built.seconds:.2f} s "
          f"(host clock) {tag}")
    for line in built.ptxas.splitlines():
        if any(k in line for k in ("registers", "smem", "Compiling entry")):
            print(f"  ptxas: {line.strip()}")

    # ---- 2. per-layer check against the plain version ------------------
    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def layer_case(l, batch, act, dtype=torch.float32):
        pads = same_deconv_pads(l.k, l.s)
        x = randn(batch, *l.in_hw, l.cin)
        w = randn(l.k, l.k, l.cin, l.cout,
                  scale=1.0 / (l.k * l.k * l.cin) ** 0.5)
        scale = randn(l.cout, scale=0.1) + 1.0
        bias = randn(l.cout, scale=0.1)
        plan = sd.plan(w.shape, l.s, pads, backend="fused", act=act,
                       device=dev).bind(w.to(dtype), scale.to(dtype), bias)
        return x.to(dtype), plan

    def run_both(x, p):
        pk, pi = p.pk, p.pi
        geo = dict(bias=p.bias, act=p.act,
                   pad=((pi[0], pi[0]), (pi[1], pi[1])),
                   crop=(pk[0] + p.padding[0][0], pk[1] + p.padding[1][0]),
                   out_space=p.out_shape(x.shape[1:3]))
        out = ops.sd_deconv_presplit_fused(
            x, p.ws, p.kernel, p.stride, p.padding,
            output_padding=p.output_padding, bias=p.bias, act=p.act,
            plan=p.tile)
        ref = K.sd_fused_ref(x, p.ws, p.stride, **geo)
        torch.cuda.synchronize()
        return out, ref

    max_err = 0.0
    failures = []
    print(f"check: K1 vs sd_fused_ref, f32, batch 4, gate "
          f"{F32_GATE}*max(1,max|ref|) {tag}")
    for net, fn in BENCHMARKS.items():
        layers = fn().layers
        for i, l in enumerate(layers):
            if l.kind != "deconv":
                continue
            act = "linear" if i == len(layers) - 1 else "relu"
            x, p = layer_case(l, 4, act)
            out, ref = run_both(x, p)
            d, tol = _gate_err(out, ref, F32_GATE, True)
            max_err = max(max_err, d)
            ok = d <= tol and tuple(out.shape) == tuple(ref.shape)
            print(f"  {net}/{l.name} {tuple(x.shape)}->{tuple(out.shape)} "
                  f"max|d| {d:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{net}/{l.name}")
    # output_padding past the shuffled support (op > pad_hi), tanh, and a
    # forced small tile so ragged tiles in both dims are exercised.
    odd = [((2, 5, 6, 3), (4, 4, 3, 2), 2, 0, 1, None),
           ((2, 5, 6, 3), (4, 4, 3, 2), 2, 1, (1, 0), None),
           ((3, 13, 11, 40), (5, 5, 40, 24), 2, 2, 1,
            KernelPlan(th=3, tw=2, tcin=16, tc=32))]
    for sx, sw_, st, padv, op, tile in odd:
        x = randn(*sx)
        w = randn(*sw_, scale=0.2)
        bias = randn(sw_[-1], scale=0.1)
        p = sd.plan(w.shape, st, padv, backend="fused", act="tanh",
                    output_padding=op, tile=tile, device=dev).bind(
                        w, bias=bias)
        out, ref = run_both(x, p)
        d, tol = _gate_err(out, ref, F32_GATE, True)
        max_err = max(max_err, d)
        ok = d <= tol and tuple(out.shape) == tuple(ref.shape)
        print(f"  odd {sx} k{sw_[0]} s{st} p{padv} op{op} tile {tile} "
              f"max|d| {d:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"odd {sx}")
    dcgan_layers = [(i, l) for i, l in enumerate(BENCHMARKS["dcgan"]().layers)
                    if l.kind == "deconv"]
    print(f"check: K1 vs sd_fused_ref, bf16 in/out, f32 accumulation, "
          f"batch 4, gate {BF16_GATE}*max|ref| {tag}")
    for i, l in dcgan_layers:
        act = "linear" if i == 3 else "relu"
        x, p = layer_case(l, 4, act, torch.bfloat16)
        out, ref = run_both(x, p)
        d, tol = _gate_err(out, ref, BF16_GATE, False)
        ok = d <= tol and out.dtype == torch.bfloat16
        print(f"  dcgan/{l.name} bf16 max|d| {d:.3e} tol {tol:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"dcgan/{l.name} bf16")
    if failures:
        raise SystemExit(f"chip_smoke: kernel disagrees with its plain "
                         f"version on {failures}")

    # ---- timing at the serving bucket ----------------------------------
    print(f"time: DCGAN layers at batch {BUCKET}, f32, CUDA events: "
          f"median [min, max] of 7 rounds of 20 warm launches, K1 / plain / "
          f"library in turns (inputs L2-resident) {tag}")
    per_layer = []
    for i, l in dcgan_layers:
        act = "linear" if i == 3 else "relu"
        x, p = layer_case(l, BUCKET, act)
        pi, pk = p.pi, p.pk
        geo = dict(bias=p.bias, act=p.act,
                   pad=((pi[0], pi[0]), (pi[1], pi[1])),
                   crop=(pk[0] + p.padding[0][0], pk[1] + p.padding[1][0]),
                   out_space=p.out_shape(x.shape[1:3]))
        kern = lambda: ops.sd_deconv_presplit_fused(     # noqa: E731
            x, p.ws, p.kernel, p.stride, p.padding, bias=p.bias, act=p.act)
        plain = lambda: K.sd_fused_ref(x, p.ws, p.stride, **geo)  # noqa
        # Library yardstick: the same-size transposed conv in one cuDNN
        # call (NCHW, symmetric crop 2 + output_padding 1 -> in*s).
        x_cf = x.permute(0, 3, 1, 2).contiguous()
        w_t = torch.randn(l.cin, l.cout, l.k, l.k, device=dev)
        lib = lambda: F.conv_transpose2d(                 # noqa: E731
            x_cf, w_t, p.bias, stride=l.s, padding=2, output_padding=1)
        assert lib().shape[2:] == kern().shape[1:3]
        t = _time_ms({"k1": kern, "plain": plain, "lib": lib})
        (ms, ms_lo, ms_hi), plain_ms, lib_ms = t["k1"], t["plain"][0], \
            t["lib"][0]
        y = kern()
        flops = 2.0 * BUCKET * l.macs()
        nbytes = sum(t.numel() * t.element_size()
                     for t in (x, p.ws, p.bias, y))
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        g = K.launch_geometry(x.shape, p.ws.shape, p.stride, geo["pad"],
                              geo["crop"], geo["out_space"])
        kt = p.kt
        smem = smem_bytes(FusedGeom(
            *l.in_hw, l.cin, p.ws.shape[-1], kt[0], kt[1], l.s, l.s,
            g.out_h, g.out_w, g.res_h, g.res_w), g.plan)
        print(f"  dcgan/{l.name} launch: tile {g.plan}, grid "
              f"{-(-p.ws.shape[-1] // g.plan.tc)} x {g.nh * g.nw} x "
              f"{BUCKET} blocks of 256 threads, {smem} B dynamic shared "
              "memory per block")
        rec = {"layer": f"dcgan/{l.name}", "x": list(x.shape),
               "y": list(y.shape), "ms": ms, "plain_ms": plain_ms,
               "ms_min": ms_lo, "ms_max": ms_hi,
               "plain_ms_range": list(t["plain"][1:]),
               "library_ms_range": list(t["lib"][1:]),
               "library_ms": lib_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "flops": flops, "bytes": nbytes, "launches_per_batch": 1}
        per_layer.append(rec)
        print(f"  dcgan/{l.name} {tuple(x.shape)}->{tuple(y.shape)}: K1 "
              f"{ms:.4f} ms [{ms_lo:.4f}, {ms_hi:.4f}], plain "
              f"{plain_ms:.4f} ms, conv_transpose2d {lib_ms:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved; sm clock, power, "
              f"temperature {_clocks()}) {tag}")

    # ---- 3. serve full-width DCGAN through the port --------------------
    server = GenServer(nets=("dcgan",), device="cuda", max_batch=BUCKET,
                       seed=SEED)
    built_cells = server.warmup()
    reqs = server.random_requests("dcgan", SERVE_REQUESTS, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.SD_FUSED_LAUNCHES = 0
    results, stats = serve_async(server, reqs)
    torch.cuda.synchronize()
    launches = K.SD_FUSED_LAUNCHES
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    lat = stats["latency_ms"]
    print(f"serve: {stats['served']} DCGAN requests (full width, f32) in "
          f"{stats['wall_s']:.4f} s host clock: {stats['req_per_s']:.1f} "
          f"req/s, p50 {lat['p50']} ms, p95 {lat['p95']} ms, "
          f"{stats['launches']} launches, {stats['compiles']} cells "
          f"({built_cells} built in warmup), peak memory {peak_mib:.1f} "
          f"MiB {tag}")
    print(f"  K1 launches in the serving run: {launches} "
          f"(3 deconv layers x {stats['launches']} batches)")
    if launches != 3 * stats["launches"] or launches == 0:
        raise SystemExit("chip_smoke: serving did not run K1 once per "
                         "deconv layer per batch")
    if stats["served"] != SERVE_REQUESTS or stats["shed"]:
        raise SystemExit(f"chip_smoke: served {stats['served']} of "
                         f"{SERVE_REQUESTS}, shed {stats['shed']}")
    model, params = server.model("dcgan")
    plain_model = GenerativeModel(model.spec, "sd_kernel",
                                  engine_backend="torch", device=dev)
    z = torch.stack([r.latent for r in reqs])
    out = torch.stack([results[r.rid] for r in reqs])
    with torch.no_grad():
        ref = plain_model.apply(params, z)
    d, tol = _gate_err(out, ref, F32_GATE, True)
    finite = bool(torch.isfinite(out).all())
    print(f"  outputs {tuple(out.shape)} finite={finite}; vs torch backend "
          f"on the card max|d| {d:.3e} tol {tol:.3e} {tag}")
    cpu_params = {k: {n: t.cpu() for n, t in v.items()}
                  for k, v in params.items()}
    cpu_ref = GenerativeModel(model.spec, "native", device="cpu").apply(
        cpu_params, z[:2].cpu())
    d_cpu, tol_cpu = _gate_err(out[:2].cpu(), cpu_ref, F32_GATE, True)
    print(f"  vs native F.conv_transpose2d on the CPU (2 requests) "
          f"max|d| {d_cpu:.3e} tol {tol_cpu:.3e}")
    if not (finite and d <= tol and d_cpu <= tol_cpu
            and tuple(out.shape) == (SERVE_REQUESTS, 64, 64, 3)):
        raise SystemExit("chip_smoke: served outputs are wrong")

    # ---- where one full batch's time goes -------------------------------
    full = [r.latent for r in reqs[:BUCKET]]
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.run_group("dcgan", full)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = sorted(host)[len(host) // 2]
    breakdown = _device_breakdown(lambda: server.run_group("dcgan", full))
    print(f"batch: one DCGAN batch of {BUCKET} through run_group: "
          f"{host_ms:.3f} ms host clock (median of 10, synchronised) "
          f"{tag}")
    if breakdown is None:
        print("  device time per kernel: not measured (the profiler "
              "reported no device time)")
    else:
        busy, wall, top = breakdown
        print(f"  profiler: device busy {busy:.3f} ms of {wall:.3f} ms wall "
              f"(idle share {1 - busy / wall:.3f}) {tag}")
        for name, ms_k, calls in top:
            print(f"    {ms_k:.4f} ms in {calls} call(s): {name[:90]}")

    # ---- 4. the six paper networks through K1 --------------------------
    print(f"nets: each paper network once at batch 1, K1 vs torch backend "
          f"{tag}")
    for net in BENCHMARKS:
        m = mk(net, "sd_kernel", engine_backend="fused", device=dev)
        params = m.init(torch.Generator().manual_seed(SEED))
        np_params = {k: {n: t.cpu().numpy() for n, t in v.items()}
                     for k, v in params.items()}
        params = params_from_numpy(np_params, dev, spec=m.spec)
        x = torch.randn(m.input_shape(1), generator=gen).to(dev)
        ref_m = mk(net, "sd_kernel", engine_backend="torch", device=dev)
        K.SD_FUSED_LAUNCHES = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            y = m.apply(params, x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        n = K.SD_FUSED_LAUNCHES
        with torch.no_grad():
            r = ref_m.apply(params, x)
        d, tol = _gate_err(y, r, F32_GATE, True)
        ndc = len(m.spec.deconv_layers())
        ok = (d <= tol and n == ndc and bool(torch.isfinite(y).all()))
        print(f"  {net}: out {tuple(y.shape)} K1 launches {n}/{ndc} "
              f"max|d| {d:.3e} tol {tol:.3e} first-call {dt:.2f} ms host "
              f"clock {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"chip_smoke: {net} failed")

    if "jax" in sys.modules or "repro" in sys.modules:
        raise SystemExit("chip_smoke: JAX or the JAX package was imported")
    total = {k: sum(r[k] for r in per_layer)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "flops", "bytes")}
    bound_by = ("operations" if total["flops"] / PEAK_F32_FLOPS
                >= total["bytes"] / PEAK_BYTES else "bytes")
    kernels = [{
        "name": "sd_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sd_fused.cu",
        "replaces": "src/repro/kernels/sd_conv.py:352",
        "launches": launches, "max_abs_err": max_err,
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"], "bound_by": bound_by,
        "library_ms": total["library_ms"]}]
    report = {"card": card, "kernels": kernels, "per_layer": per_layer,
              "serve": {k: stats[k] for k in
                        ("served", "launches", "req_per_s", "wall_s",
                         "latency_ms")},
              "peak_mib": peak_mib, "nvcc_s": built.seconds,
              "batch_host_ms": host_ms, "batch_device": breakdown,
              "ptxas": built.ptxas}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(report, f, indent=1)
    elapsed = time.perf_counter() - t_start
    print(f"total {elapsed:.1f} s host clock (limit {TIME_LIMIT_S} s) {tag}")
    print("(ms/plain_ms/bound_ms/library_ms below: sum over DCGAN's three "
          f"deconv layers at batch {BUCKET}) {tag}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="", metavar="PATH",
                    help="also write the full report (per-layer times, "
                         "serving stats, ptxas output) to PATH")
    sys.exit(main(ap.parse_args().json))
