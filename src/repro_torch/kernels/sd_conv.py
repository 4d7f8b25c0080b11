"""The fused split-deconv kernel (K1) and its plain PyTorch version.

:func:`sd_fused` has the contract of the TPU kernel ``sd_fused_pallas``
(``src/repro/kernels/sd_conv.py``): split stride-1 conv over the
logically ``P_I``-zero-padded input, ``sh x sw`` pixel-shuffle of the
oc-major phase channels, per-oc bias, linear/relu/tanh and the low-side
crop, written once in final output geometry.  On a CUDA tensor it
launches the CUDA kernel ``csrc/sd_fused.cu`` (built at first use) or
raises; on a CPU tensor it runs :func:`sd_fused_ref`, the same function
in plain PyTorch.  ``SD_FUSED_LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.deconv import conv_valid, crop_interleaved
from repro_torch.kernels.autotune import (FusedGeom, KernelPlan,
                                          heuristic_plan, smem_bytes,
                                          SMEM_BUDGET)

PadPair = Tuple[int, int]
ACTS = {"linear": 0, "relu": 1, "tanh": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SD_FUSED_LAUNCHES = 0      # kernel launches; the plain version never counts


def _pair(s) -> Tuple[int, int]:
    return (s, s) if isinstance(s, int) else (int(s[0]), int(s[1]))


def _apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "linear":
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "tanh":
        return torch.tanh(y)
    raise ValueError(f"unknown act {act!r}")


def _full_space(x_shape, ws_shape, s, pad):
    (sh, sw), (_, h, wd, _) = _pair(s), x_shape
    (plo_h, phi_h), (plo_w, phi_w) = pad
    return ((h + plo_h + phi_h - ws_shape[0] + 1) * sh,
            (wd + plo_w + phi_w - ws_shape[1] + 1) * sw)


def sd_fused_ref(x: torch.Tensor, ws_ocmajor: torch.Tensor, s, *,
                 bias: Optional[torch.Tensor] = None, act: str = "linear",
                 pad: Tuple[PadPair, PadPair] = ((0, 0), (0, 0)),
                 crop: Tuple[int, int] = (0, 0),
                 out_space: Optional[Tuple[int, int]] = None
                 ) -> torch.Tensor:
    """Plain PyTorch version of :func:`sd_fused`: ``F.pad``, ``F.conv2d``
    in f32, the oc-major interleave, crop (zero-extended past the
    support), bias, activation, cast to ``x.dtype``."""
    sh, sw = _pair(s)
    (plo_h, phi_h), (plo_w, phi_w) = pad
    xp = F.pad(x.float(), (0, 0, plo_w, phi_w, plo_h, phi_h))
    y = conv_valid(xp, ws_ocmajor.float())      # (B, Hc, Wc, Cout*sh*sw)
    b, hc, wc, nc = y.shape
    cout = nc // (sh * sw)
    y = y.reshape(b, hc, wc, cout, sh, sw).permute(0, 1, 4, 2, 5, 3)
    y = y.reshape(b, hc * sh, wc * sw, cout)
    if out_space is None:
        out_space = (hc * sh, wc * sw)
    y = crop_interleaved(y, (0, 0), ((crop[0], 0), (crop[1], 0)),
                         out_space)
    if bias is not None:
        y = y + bias.float()
    return _apply_act(y, act).to(x.dtype)


@dataclass(frozen=True)
class LaunchGeometry:
    """The integers the kernel is handed for one launch (all computed in
    Python, so the CPU tests reach them).  The low-side crop ``c = s*q +
    r`` becomes a ``q``-row band offset plus a static ``r``-row slice of
    the interleaved tile; the first ``min(q, P_I)`` padded rows are never
    read, so the origin shifts by that much (``q``, ``plo`` after the
    shift)."""
    q_h: int
    q_w: int
    plo_h: int
    plo_w: int
    res_h: int
    res_w: int
    out_h: int
    out_w: int
    nh: int
    nw: int
    plan: KernelPlan


def launch_geometry(x_shape, ws_shape, s, pad, crop, out_space,
                    plan: Optional[KernelPlan] = None) -> LaunchGeometry:
    sh, sw = _pair(s)
    _, h, wd, cin = x_shape
    kth, ktw, _, nc = ws_shape
    (plo_h, _), (plo_w, _) = pad
    oh, ow = out_space
    q_h, res_h = crop[0] // sh, crop[0] % sh
    q_w, res_w = crop[1] // sw, crop[1] % sw
    sh_h, sh_w = min(q_h, plo_h), min(q_w, plo_w)
    geom = FusedGeom(h=h, w=wd, cin=cin, nc=nc, kth=kth, ktw=ktw, sh=sh,
                     sw=sw, out_h=oh, out_w=ow, res_h=res_h, res_w=res_w)
    plan = plan if plan is not None else heuristic_plan(geom)
    if smem_bytes(geom, plan) > SMEM_BUDGET:
        raise ValueError(f"tile {plan} needs {smem_bytes(geom, plan)} bytes "
                         f"of shared memory; a block has {SMEM_BUDGET}")
    return LaunchGeometry(
        q_h=q_h - sh_h, q_w=q_w - sh_w, plo_h=plo_h - sh_h,
        plo_w=plo_w - sh_w, res_h=res_h, res_w=res_w, out_h=oh, out_w=ow,
        nh=-(-oh // (plan.th * sh)), nw=-(-ow // (plan.tw * sw)), plan=plan)


def _check_cuda_operands(x, ws, bias, sh, sw):
    if x.dtype not in DTYPES:
        raise TypeError(f"sd_fused kernel takes float32 or bfloat16 input, "
                        f"got {x.dtype} (the int8 branch is not ported)")
    if ws.dtype != x.dtype:
        raise TypeError(f"filter dtype {ws.dtype} != input dtype {x.dtype}")
    if x.ndim != 4 or ws.ndim != 4 or ws.shape[2] != x.shape[3]:
        raise ValueError(f"shapes x {tuple(x.shape)}, ws {tuple(ws.shape)} "
                         "are not (B,H,W,Cin), (KTh,KTw,Cin,Cout*sh*sw)")
    if ws.shape[3] % (sh * sw):
        raise ValueError(f"{ws.shape[3]} phase channels do not divide by "
                         f"{sh}x{sw} phases")
    for t in (x, ws, bias):
        if t.device != x.device:
            raise ValueError("sd_fused operands must share one device")
        if not t.is_contiguous():
            raise ValueError("sd_fused operands must be contiguous")


def sd_fused(x: torch.Tensor, ws_ocmajor: torch.Tensor, s, *,
             bias: Optional[torch.Tensor] = None, act: str = "linear",
             pad: Tuple[PadPair, PadPair] = ((0, 0), (0, 0)),
             crop: Tuple[int, int] = (0, 0),
             out_space: Optional[Tuple[int, int]] = None,
             plan: Optional[KernelPlan] = None) -> torch.Tensor:
    """Fused SD, zero-copy: split-filter conv + interleaved write.

    x: (B, H, W, Cin) unpadded; ``pad`` (the ``P_I`` halo) is applied in
    the kernel by masked reads.  ws_ocmajor: (KTh, KTw, Cin, Cout*sh*sw),
    channel ``oc*sh*sw + phase``.  ``s``: an int or ``(sh, sw)``.  bias:
    (Cout,), added in f32.  crop: low-side crop per dim in interleaved
    coordinates.  out_space: final output spatial shape (rows past the
    shuffled support come out as ``act(bias)``); defaults to the
    uncropped interleave.  Returns (B, *out_space, Cout) in ``x.dtype``.
    """
    global SD_FUSED_LAUNCHES
    sh, sw = _pair(s)
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    if out_space is None:
        out_space = _full_space(x.shape, ws_ocmajor.shape, s, pad)
    if x.device.type == "cpu":
        return sd_fused_ref(x, ws_ocmajor, s, bias=bias, act=act, pad=pad,
                            crop=crop, out_space=out_space)
    if x.device.type != "cuda":
        raise ValueError(f"sd_fused runs on cuda or cpu, not {x.device}")
    cout = ws_ocmajor.shape[-1] // (sh * sw)
    if bias is None:
        bias = torch.zeros(cout, device=x.device)
    bias = bias.float().contiguous()
    _check_cuda_operands(x, ws_ocmajor, bias, sh, sw)
    g = launch_geometry(x.shape, ws_ocmajor.shape, (sh, sw), pad, crop,
                        out_space, plan)
    b, h, wd, cin = x.shape
    y = torch.empty((b, g.out_h, g.out_w, cout), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    if g.nh * g.nw > 65535:
        raise ValueError(f"{g.nh * g.nw} spatial tiles exceed the grid's "
                         "y limit; use a larger tile")
    from repro_torch.kernels.build import load
    fn = load("sd_fused").fn
    p = g.plan
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), ws_ocmajor.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), DTYPES[x.dtype], b, h, wd, cin, cout,
                 ws_ocmajor.shape[0], ws_ocmajor.shape[1], sh, sw,
                 g.q_h, g.q_w, g.plo_h, g.plo_w, g.res_h, g.res_w,
                 g.out_h, g.out_w, p.th, p.tw, p.tcin, p.tc, ACTS[act],
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sd_fused kernel launch failed: CUDA error {err}")
    SD_FUSED_LAUNCHES += 1
    return y
