"""Tile sweep of the port's GEMM-shaped kernels on one NVIDIA GPU: K1's
float and int8 branches and K2 in f32 and int8 (the implicit GEMM), K3
(the filter grad on the same tiles) and K4 (the Winograd split deconv).

For each DCGAN deconv layer at the serving bucket (batch 16) it times K1
(the fused split deconv, f32), K1 int8 (the same launch on int8 codes
with the dynamic (B, NC) scale, on the s8 tensor cores), K2 (the
stride-1 conv of the backward's input grad, dx) and K3 (the backward's
filter grad, dw) on every forced ``GemmPlan(bn, splits)`` the kernel
takes (``bn`` in ``GEMM_BN``; splits up to 16 for K1/K2 and up to 192
for K3 while each split keeps a k-tile), and K4 (f32) on a set of
``WinoPlan``s (channel tiles 16 and 32, whole samples and bands of
tiles; the pools are ``autotune.gemm_plans`` and ``autotune.wino_plans``,
which the plan cache's candidates come from), in device time: CUDA
events over 20 calls queued behind ``torch.cuda._sleep``
(``repro_torch.kernels.timing.ahead_ms``), the median of 3.
Every plan's output is held to the default plan's (f32 gate; int8
bit-identical).  Per case it prints each plan's grid and time, the
default plan's (``gemm_plan``, ``filter_grad_plan``, ``wino_plan``),
the best plans with their block counts and the default's time over the
best's: the data that the default rules rest on (``GEMM_WAVES`` /
``DW_WAVES`` blocks per SM).  It also times K1 in bf16 (one tensor-core
pass instead of 3xTF32's three) on the default plan, and K2 int8 (the
3-D lowering's tap conv on the s8 tensor cores) on every plan at
VoxGAN's three tap convs (batch 16, output depth folded into the batch;
int8 bit-identical).

Run from the repo root on a machine with a CUDA card::

    PYTHONPATH=src python3 gemm_sweep.py [--json PATH]

It prints the card's name and power limit first; ``--json`` writes every
reading.  It exits non-zero without a card.  Imports torch, never JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from chip_smoke import _card_line

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 16
SEED = 0
DW_MORE_SPLITS = (24, 32, 48, 64, 96, 128, 145, 192)   # K3's longer pool


def sweep(dev, time_ms, card: str) -> dict:
    """The readings on device ``dev``, each plan timed by
    ``time_ms(fn)``; raises if a plan's output leaves the f32 gate of the
    default plan's."""
    import torch
    from repro_torch import sd
    from repro_torch.core.accounting import BENCHMARKS, WORKLOADS
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.kernels import ops
    from repro_torch.kernels import sd_conv as K
    from repro_torch.kernels import winograd as W
    from repro_torch.core.quant import quantize_act
    from repro_torch.kernels.autotune import (ConvGeom, FilterGradGeom,
                                              SPLITS, GemmPlan,
                                              filter_grad_plan,
                                              gemm_grid, gemm_plan,
                                              gemm_plans, wino_grid,
                                              wino_plans)
    from repro_torch.sd.grad import split_cotangent

    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    cases = []
    for l in BENCHMARKS["dcgan"]().deconv_layers():
        pads = same_deconv_pads(l.k, l.s)
        w = randn(l.k, l.k, l.cin, l.cout,
                  scale=1.0 / (l.k * l.k * l.cin) ** 0.5)
        x = randn(BATCH, *l.in_hw, l.cin)
        p = sd.plan(w.shape, l.s, pads, backend="fused", act="relu",
                    device=dev).bind(w, None, randn(l.cout, scale=0.1))
        g1 = K.gemm_launch(x.shape, p.ws.shape, p.stride,
                           tuple((q, q) for q in p.pi),
                           (p.pk[0] + p.padding[0][0],
                            p.pk[1] + p.padding[1][0]),
                           p.out_shape(x.shape[1:3])).geom

        def k1(plan, x=x, p=p):
            return ops.sd_deconv_presplit_fused(
                x, p.ws, p.kernel, p.stride, p.padding, bias=p.bias,
                act=p.act, plan=plan)

        dy1 = split_cotangent(p, randn(BATCH, *p.out_shape(l.in_hw), l.cout))
        w_t = p.ws.flip(0, 1).transpose(-1, -2).contiguous()
        g2 = ConvGeom(h=dy1.shape[1], w=dy1.shape[2], cin=dy1.shape[3],
                      co=l.cin, kth=p.kt[0], ktw=p.kt[1], out_h=l.in_hw[0],
                      out_w=l.in_hw[1]).as_gemm(BATCH)

        def k2(plan, dy1=dy1, w_t=w_t, p=p, l=l):
            return K.sd_conv(dy1, w_t, pad=tuple((k - 1, k - 1)
                                                 for k in p.kt),
                             out_start=p.pi, out_size=tuple(l.in_hw),
                             plan=plan)

        pad = tuple((q, q) for q in p.pi)
        g3 = FilterGradGeom(b=BATCH, h=l.in_hw[0], w=l.in_hw[1], cin=l.cin,
                            nco=dy1.shape[-1], kth=p.kt[0], ktw=p.kt[1],
                            o1h=dy1.shape[1], o1w=dy1.shape[2])

        def k3(plan, x=x, dy1=dy1, p=p, pad=pad):
            return K.sd_filter_grad(x, dy1, p.kt, pad=pad, plan=plan)

        pw = sd.plan(w.shape, l.s, pads, backend="winograd", act="relu",
                     device=dev).bind(w, None, p.bias)
        g4 = W.wino_launch(tuple(x.shape), tuple(pw.ws.shape), pw.kt,
                           pw.stride, pad, (pw.pk[0] + pw.padding[0][0],
                                            pw.pk[1] + pw.padding[1][0]),
                           pw.out_shape(x.shape[1:3])).geom

        def k4(plan, x=x, pw=pw):
            return ops.sd_deconv_presplit_wino(
                x, pw.ws, pw.kernel, pw.stride, pw.padding, bias=pw.bias,
                act=pw.act, plan=plan)

        p8 = sd.plan(w.shape, l.s, pads, backend="fused", act="relu",
                     dtype="int8", device=dev).bind(w, None, p.bias)
        xq, sxs = quantize_act(x)
        comb = (sxs[:, None] * p8.wscale[None, :]).contiguous()
        g1q = K.gemm_launch(xq.shape, p8.ws.shape, p8.stride,
                            tuple((q, q) for q in p8.pi),
                            (p8.pk[0] + p8.padding[0][0],
                             p8.pk[1] + p8.padding[1][0]),
                            p8.out_shape(x.shape[1:3]), dtype="int8").geom

        def k1q(plan, xq=xq, p8=p8, comb=comb):
            return ops.sd_deconv_presplit_fused(
                xq, p8.ws, p8.kernel, p8.stride, p8.padding, bias=p8.bias,
                act=p8.act, scale=comb, plan=plan)

        cases.append((f"K1 dcgan/{l.name}", g1, k1, gemm_plan(g1),
                      gemm_plans(g1), (x, p)))
        cases.append((f"K1 int8 dcgan/{l.name}", g1q, k1q, gemm_plan(g1q),
                      gemm_plans(g1q), None))
        cases.append((f"K2 dx dcgan/{l.name}", g2, k2, gemm_plan(g2),
                      gemm_plans(g2), None))
        cases.append((f"K3 dw dcgan/{l.name}", g3.as_gemm(), k3,
                      filter_grad_plan(g3), gemm_plans(
                          g3.as_gemm(), SPLITS + DW_MORE_SPLITS), None))
        cases.append((f"K4 dcgan/{l.name}", g4, k4, W.wino_plan(g4),
                      wino_plans(g4), None))

    for l in WORKLOADS["voxgan"]().deconv_layers():
        pv = sd.plan((4, 4, 4, l.cin, l.cout), 2,
                     same_deconv_pads((4,) * 3, (2,) * 3), backend="fused",
                     device=dev)
        od = l.in_hw[0] + 2 * pv.pi[0] - pv.kt[0] + 1
        xq = torch.randint(-127, 128, (BATCH * od, *l.in_hw[1:], l.cin),
                           generator=gen, dtype=torch.int8).to(dev)
        wq = torch.randint(-127, 128, (*pv.kt[1:], l.cin,
                                       pv.phases * l.cout),
                           generator=gen, dtype=torch.int8).to(dev)
        vpad = ((pv.pi[1],) * 2, (pv.pi[2],) * 2)
        y = K.sd_conv(xq, wq, pad=vpad)
        g2q = ConvGeom(h=xq.shape[1], w=xq.shape[2], cin=l.cin,
                       co=wq.shape[3], kth=pv.kt[1], ktw=pv.kt[2],
                       out_h=y.shape[1], out_w=y.shape[2],
                       dtype="int8").as_gemm(xq.shape[0])

        def k2q(plan, xq=xq, wq=wq, vpad=vpad):
            return K.sd_conv(xq, wq, pad=vpad, plan=plan)

        cases.append((f"K2 int8 voxgan/{l.name} tap", g2q, k2q,
                      gemm_plan(g2q), gemm_plans(g2q), None))

    out = {"card": card, "batch": BATCH, "cases": []}
    for name, geom, fn, default, plans, bf16 in cases:
        grid = wino_grid if name.startswith("K4") else gemm_grid
        ref = fn(default)
        rows = []
        for plan in plans:
            # every plan computes the same sums in another order; int8's
            # are exact, so its plans agree bit for bit
            d = (fn(plan) - ref).abs().max().item()
            tol = (0.0 if " int8 " in name else
                   1e-4 * max(1.0, ref.abs().max().item()))
            if not d <= tol:
                raise RuntimeError(f"{name} {plan} differs by {d}")
            rows.append({"plan": str(plan),
                         "blocks": math.prod(grid(geom, plan)),
                         "ms": time_ms(lambda: fn(plan))})
        dms = time_ms(lambda: fn(default))
        rows.sort(key=lambda r: r["ms"])
        rec = {"case": name, "geom": str(geom),
               "default": {"plan": str(default),
                           "blocks": math.prod(grid(geom, default)),
                           "ms": dms},
               "plans": rows}
        best = ", ".join(f"{r['plan']} {r['blocks']} blocks {r['ms']:.4f}"
                         for r in rows[:3])
        one = ""
        if not name.startswith("K4"):
            rec["splits_1_ms"] = next(
                r["ms"] for r in rows
                if r["plan"] == str(GemmPlan(default.bn, 1)))
            one = (f"; one split at bn {default.bn} "
                   f"{rec['splits_1_ms']:.4f} ms")
        rec["default_over_best"] = dms / rows[0]["ms"]
        print(f"{name}: {geom}; default {default} "
              f"{rec['default']['blocks']} blocks {dms:.4f} ms, "
              f"{rec['default_over_best']:.3f}x the best; best "
              f"{best}{one} [device ms, {card}]")
        if bf16 is not None:
            x, p = bf16
            xb, wb = x.bfloat16(), p.ws.bfloat16()
            rec["bf16_ms"] = time_ms(
                lambda: ops.sd_deconv_presplit_fused(
                    xb, wb, p.kernel, p.stride, p.padding, bias=p.bias,
                    act=p.act))
            print(f"  {name} bf16 (one pass) {rec['bf16_ms']:.4f} ms vs f32 "
                  f"(3xTF32) {dms:.4f} ms: {dms / rec['bf16_ms']:.2f}x")
        out["cases"].append(rec)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="", help="write the readings here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gemm_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    card = _card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.timing import ahead_ms
    out = sweep(torch.device("cuda"),
                lambda fn: sorted(ahead_ms(fn) for _ in range(3))[1],
                card)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
