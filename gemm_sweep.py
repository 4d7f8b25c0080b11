"""Tile sweep of the float implicit GEMM (K1's float branch and K2 in f32)
on one NVIDIA GPU.

For each DCGAN deconv layer at the serving bucket (batch 16) it times K1
(the fused split deconv, f32) and K2 (the stride-1 conv of the backward's
input grad, dx) on every forced ``GemmPlan(bn, splits)`` the kernel takes
(``bn`` in ``GEMM_BN``, splits up to 16 while each split keeps a k-tile),
in device time: CUDA events over 20 calls queued behind
``torch.cuda._sleep`` (chip_smoke's ``_ahead_ms``), the median of 3.
Per case it prints each plan's grid and time, the default
``gemm_plan``'s, and the best plans with their block counts: the data
that ``gemm_plan``'s split rule (``GEMM_WAVES`` blocks per SM) rests
on.  It also times K1 in bf16 (one
tensor-core pass instead of 3xTF32's three) on the default plan.

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

from chip_smoke import _ahead_ms, _card_line

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 16
SEED = 0
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def sweep(dev, time_ms, card: str) -> dict:
    """The readings on device ``dev``, each plan timed by
    ``time_ms(fn)``; raises if a plan's output leaves the f32 gate of the
    default plan's."""
    import torch
    from repro_torch import sd
    from repro_torch.core.accounting import BENCHMARKS
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.kernels import ops
    from repro_torch.kernels import sd_conv as K
    from repro_torch.kernels.autotune import (GEMM_BN, ConvGeom, GemmPlan,
                                              gemm_grid, gemm_k_tiles,
                                              gemm_plan)
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

        cases.append((f"K1 dcgan/{l.name}", g1, k1, (x, p)))
        cases.append((f"K2 dx dcgan/{l.name}", g2, k2, None))

    out = {"card": card, "batch": BATCH, "cases": []}
    for name, geom, fn, bf16 in cases:
        default = gemm_plan(geom)
        ref = fn(default)
        rows = []
        for bn in GEMM_BN:
            for sp in SPLITS:
                if sp > gemm_k_tiles(geom):
                    continue
                plan = GemmPlan(bn, sp)
                # every plan computes the same sums in another order
                d = (fn(plan) - ref).abs().max().item()
                tol = 1e-4 * max(1.0, ref.abs().max().item())
                if not d <= tol:
                    raise RuntimeError(f"{name} {plan} differs by {d}")
                rows.append({"bn": bn, "splits": sp,
                             "blocks": math.prod(gemm_grid(geom, plan)),
                             "ms": time_ms(lambda: fn(plan))})
        dms = time_ms(lambda: fn(default))
        rows.sort(key=lambda r: r["ms"])
        one = next(r["ms"] for r in rows
                   if r["bn"] == default.bn and r["splits"] == 1)
        rec = {"case": name, "m": geom.m, "n": geom.n, "k": geom.k,
               "default": {"bn": default.bn, "splits": default.splits,
                           "blocks": math.prod(gemm_grid(geom, default)),
                           "ms": dms},
               "splits_1_ms": one, "plans": rows}
        best = ", ".join(f"({r['bn']}, {r['splits']}) {r['blocks']} blocks "
                         f"{r['ms']:.4f}" for r in rows[:3])
        print(f"{name}: GEMM {geom.m} x {geom.n} x {geom.k}; default "
              f"{default} {rec['default']['blocks']} blocks {dms:.4f} ms; "
              f"best {best}; one split at bn {default.bn} {one:.4f} ms "
              f"[device ms, {card}]")
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
    out = sweep(torch.device("cuda"),
                lambda fn: sorted(_ahead_ms(fn) for _ in range(3))[1],
                card)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
