"""The port's split-deconv kernels and their plain PyTorch versions.

K1, :func:`sd_fused`, has the contract of the TPU kernel ``sd_fused_pallas``
(``src/repro/kernels/sd_conv.py``): split stride-1 conv over the
logically ``P_I``-zero-padded input, ``sh x sw`` pixel-shuffle of the
oc-major phase channels, per-oc bias, linear/relu/tanh and the low-side
crop, written once in final output geometry.  On a CUDA tensor it
launches the CUDA kernel ``csrc/sd_fused.cu`` (built at first use) or
raises; on a CPU tensor it runs :func:`sd_fused_ref`, the same function
in plain PyTorch.  ``SD_FUSED_LAUNCHES`` counts kernel launches.

K1's float branch and K2 in f32 are one implicit GEMM on the tensor
cores in 3xTF32 (``csrc/sd_igemm.cuh``; bf16 in one exact pass), tiled
by a :class:`~repro_torch.kernels.autotune.GemmPlan`.  The integers K1
is handed come from :func:`gemm_launch`; a plan with ``splits > 1``
runs the split GEMM and then the ordered sum of its partials with the
epilogue, and that call counts as one launch.

K1's int8 branch takes an int8 ``(x, ws)`` pair and the combined dequant
``scale``: (B, Cout*sh*sw) on the dynamic path, or one static (1,
Cout*sh*sw) row on the calibrated path, which the kernel reads in place
for every sample.  int8 x int8 tap GEMMs accumulated exactly in int32,
the scale applied per phase channel before the interleave, K1's
epilogue, f32 output; or, with ``out_dtype=torch.int8`` (the chained
epilogue: linear or relu, the next layer's ``1/sx`` already folded into
scale and bias), the activated value rounded half to even and clamped to
+-127 into int8.  On a CUDA tensor it launches ``csrc/sd_fused_int8.cu``
(counted by ``SD_FUSED_INT8_LAUNCHES``, never by
``SD_FUSED_LAUNCHES``); its plain version is :func:`sd_fused_ref` on the
int8 pair, which sums exactly (:func:`exact_conv_valid`) and rounds the
sum to f32 once, where the kernel does, then takes the kernel's steps in
its order.

A kernel's output carries no autograd graph, so the forward wrappers
(K1 here, K4 in :mod:`~repro_torch.kernels.winograd`) raise when an
operand on the card requires grad while grad mode is on
(:func:`check_no_grad`); the differentiable path is
:func:`repro_torch.sd.conv_transpose`.

The SD backward's two kernels follow the same rule (a CUDA tensor
launches the kernel or raises; a CPU tensor runs the plain version):
K2, :func:`sd_conv` (``csrc/sd_conv.cu``, contract of ``sd_conv_pallas``:
a stride-1 VALID conv with in-kernel pad and an output window), and K3,
:func:`sd_filter_grad` (``csrc/sd_filter_grad.cu``, contract of
``sd_filter_grad_pallas``).  Their counters are ``SD_CONV_LAUNCHES`` and
``SD_FILTER_GRAD_LAUNCHES``.  Both take f32.

K2's int8 pair: :func:`sd_conv` on an int8 ``(x, w)`` pair returns the
exact int32 conv, the caller owning the dequant.  On a CUDA tensor it
launches ``csrc/sd_conv_int8.cu`` (counted by ``SD_CONV_INT8_LAUNCHES``,
never by ``SD_CONV_LAUNCHES``); its plain version is :func:`sd_conv_ref`
on the int8 pair (:func:`exact_conv_valid` over the padded, windowed
input).  Its caller is the 3-D lowering
(:func:`~repro_torch.kernels.ops.sd_deconv_presplit_fused_3d`), one
launch per depth tap.
"""

from __future__ import annotations

import ctypes
import itertools
import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.deconv import (conv_valid, conv_valid_filter_grad,
                                     crop_interleaved)
from repro_torch.kernels.autotune import (DW_TCI, ConvGeom, FilterGradGeom,
                                          FilterGradPlan, FusedGeom,
                                          GemmGeom, GemmPlan, KernelPlan,
                                          check_gemm_plan, conv_plan,
                                          dw_splits, filter_grad_plan,
                                          gemm_plan, heuristic_plan,
                                          smem_bytes, SMEM_BUDGET)

PadPair = Tuple[int, int]
ACTS = {"linear": 0, "relu": 1, "tanh": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INT32_MAX_SUM = 2 ** 31    # the int8 branch's int32 accumulator must stay below
CHAIN_ACTS = ("linear", "relu")   # commute with a positive scale

SD_FUSED_LAUNCHES = 0      # kernel launches; the plain version never counts
SD_FUSED_INT8_LAUNCHES = 0
SD_CONV_LAUNCHES = 0
SD_CONV_INT8_LAUNCHES = 0
SD_FILTER_GRAD_LAUNCHES = 0


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


def check_no_grad(name: str, *ts: Optional[torch.Tensor]) -> None:
    """Raise when grad mode is on and an operand requires grad: the
    kernel's output would carry no graph, and the caller's backward would
    silently miss this layer."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise RuntimeError(
            f"{name}: an operand requires grad under grad mode, but the "
            "kernel's output has no autograd graph; train through "
            "repro_torch.sd.conv_transpose, or run under torch.no_grad()")


def exact_conv_valid(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Stride-1 VALID channels-last conv of integer-valued operands (int8
    codes), any rank, exact: one f64 GEMM per tap, every product and
    partial sum an integer below 2^53.  xq (B, *S, Cin), wq (*KT, Cin, N)
    -> (B, *(S - KT + 1), N) f64 holding the int32 sums."""
    rank = wq.ndim - 2
    out = [n - k + 1 for n, k in zip(xq.shape[1:1 + rank], wq.shape[:rank])]
    xd, wd = xq.double(), wq.double()
    y = xd.new_zeros((xq.shape[0], *out, wq.shape[-1]))
    for tap in itertools.product(*(range(k) for k in wq.shape[:rank])):
        win = tuple(slice(t, t + o) for t, o in zip(tap, out))
        y += xd[(slice(None),) + win] @ wd[tap]
    return y


def check_int32_terms(terms: int, what: str) -> None:
    """Refuse an exact int8 sum of ``terms`` products of up to 127^2 that
    could reach 2^31, the int32 accumulator's limit."""
    if terms * 127 * 127 >= INT32_MAX_SUM:
        raise ValueError(
            f"{what} sums {terms} products of up to 127^2, which can reach "
            "2^31: the int32 accumulator would overflow")


def quant_contract(x, ws, scale, out_dtype, act: str = "linear"
                   ) -> Optional[torch.dtype]:
    """Check the launch against K1's contract on any device: None for a
    float launch, else the dtype the int8 launch writes.  The int8 branch
    takes an int8 pair and the f32 combined scale, (B, Cout*sh*sw) or a
    static (1, Cout*sh*sw) row; it writes f32, or int8 (``out_dtype``,
    the chained epilogue) with a linear or relu ``act``; it refuses a
    geometry whose exact sum could overflow its int32 accumulator.  Any
    rank: ``ws`` is ``(*KT, Cin, NC)`` and every tap counts toward the
    sum."""
    quant = x.dtype == torch.int8 or ws.dtype == torch.int8
    if not quant:
        if scale is not None:
            raise ValueError("scale requires an int8 (x, ws) pair")
        if out_dtype is not None and out_dtype != x.dtype:
            raise ValueError(f"a float launch writes {x.dtype}, not "
                             f"{out_dtype}")
        return None
    if x.dtype != torch.int8 or ws.dtype != torch.int8:
        raise TypeError(f"the int8 branch takes an int8 (x, ws) pair, got "
                        f"{x.dtype} and {ws.dtype}")
    if out_dtype not in (None, torch.float32, torch.int8):
        raise TypeError(f"the int8 branch writes float32 or int8, not "
                        f"{out_dtype}")
    if out_dtype == torch.int8 and act not in CHAIN_ACTS:
        raise ValueError(f"int8 output cannot fold the next layer's scale "
                         f"through act {act!r}; only {CHAIN_ACTS} commute "
                         "with a positive scale")
    if scale is None:
        raise ValueError("an int8 launch needs the combined dequant scale "
                         "(B, Cout*sh*sw) or (1, Cout*sh*sw)")
    nc, b = ws.shape[-1], x.shape[0]
    if scale.ndim != 2 or scale.shape[1] != nc:
        raise ValueError(f"scale {tuple(scale.shape)} is not (B, {nc}) or "
                         f"(1, {nc})")
    if scale.shape[0] not in (1, b):
        raise ValueError(f"scale has {scale.shape[0]} rows for batch {b}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if scale.device != x.device or not scale.is_contiguous():
        raise ValueError("scale must be contiguous on the input's device")
    check_int32_terms(x.shape[-1] * math.prod(ws.shape[:-2]),
                      "an int8 split conv over Cin x taps")
    return torch.float32 if out_dtype is None else out_dtype


def _full_space(x_shape, ws_shape, s, pad):
    (sh, sw), (_, h, wd, _) = _pair(s), x_shape
    (plo_h, phi_h), (plo_w, phi_w) = pad
    return ((h + plo_h + phi_h - ws_shape[0] + 1) * sh,
            (wd + plo_w + phi_w - ws_shape[1] + 1) * sw)


def sd_fused_ref(x: torch.Tensor, ws_ocmajor: torch.Tensor, s, *,
                 bias: Optional[torch.Tensor] = None, act: str = "linear",
                 pad: Tuple[PadPair, PadPair] = ((0, 0), (0, 0)),
                 crop: Tuple[int, int] = (0, 0),
                 out_space: Optional[Tuple[int, int]] = None,
                 scale: Optional[torch.Tensor] = None,
                 out_dtype: Optional[torch.dtype] = None
                 ) -> torch.Tensor:
    """Plain PyTorch version of :func:`sd_fused`: ``F.pad``, ``F.conv2d``
    in f32, the oc-major interleave, crop (zero-extended past the
    support), bias, activation, cast to ``x.dtype``.  On an int8 pair:
    the exact sums (:func:`exact_conv_valid`), rounded to f32 once,
    times ``scale[b, c]`` per phase channel before the interleave (a
    static (1, NC) row broadcasts over the batch), then the same
    epilogue in f32, and for ``out_dtype=torch.int8`` the kernel's round
    half to even and clamp to +-127 (:func:`shuffle_epilogue`)."""
    (plo_h, phi_h), (plo_w, phi_w) = pad
    if x.dtype == torch.int8:
        xp = F.pad(x, (0, 0, plo_w, phi_w, plo_h, phi_h))
        y = exact_conv_valid(xp, ws_ocmajor).float() * scale[:, None, None]
        return shuffle_epilogue(y, s, bias, act, crop, out_space,
                                out_dtype or torch.float32)
    xp = F.pad(x.float(), (0, 0, plo_w, phi_w, plo_h, phi_h))
    y = conv_valid(xp, ws_ocmajor.float())      # (B, Hc, Wc, Cout*sh*sw)
    return shuffle_epilogue(y, s, bias, act, crop, out_space, x.dtype)


def shuffle_epilogue(y: torch.Tensor, s, bias: Optional[torch.Tensor],
                     act: str, crop: Tuple[int, int],
                     out_space: Optional[Tuple[int, int]],
                     dtype: torch.dtype) -> torch.Tensor:
    """The fused kernels' tail in plain PyTorch, from the f32 split-conv
    output ``y`` (B, Hc, Wc, Cout*sh*sw) with oc-major phase channels:
    interleave, crop (zero-extended past the support), bias, activation,
    cast to ``dtype``; an int8 ``dtype`` is K1 int8's chained epilogue,
    round half to even and clamp to +-127 in f32 before the cast."""
    sh, sw = _pair(s)
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
    y = _apply_act(y, act)
    return requantize(y) if dtype == torch.int8 else y.to(dtype)


def requantize(y: torch.Tensor) -> torch.Tensor:
    """The chained epilogue's requantization of an f32 value already in
    the next layer's code units: round half to even, clamp to +-127
    (never a wrapping cast), int8."""
    return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)


def _crop_origin(s, pad, crop):
    """``(q_h, q_w, plo_h, plo_w, res_h, res_w)``: the low-side crop ``c =
    s*q + r`` as a ``q``-row band offset plus a static ``r``-row slice of
    the interleaved output; the first ``min(q, P_I)`` padded rows are
    never read, so the origin shifts by that much (``q``, ``plo`` after
    the shift)."""
    sh, sw = _pair(s)
    (plo_h, _), (plo_w, _) = pad
    q_h, res_h = crop[0] // sh, crop[0] % sh
    q_w, res_w = crop[1] // sw, crop[1] % sw
    sh_h, sh_w = min(q_h, plo_h), min(q_w, plo_w)
    return q_h - sh_h, q_w - sh_w, plo_h - sh_h, plo_w - sh_w, res_h, res_w


@dataclass(frozen=True)
class LaunchGeometry:
    """The integers K1's int8 branch is handed for one launch (all
    computed in Python, so the CPU tests reach them): the crop origin of
    :func:`_crop_origin`, the output shape and the ``nh x nw`` tiles of
    its :class:`KernelPlan`."""
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
    oh, ow = out_space
    q_h, q_w, plo_h, plo_w, res_h, res_w = _crop_origin(s, pad, crop)
    geom = FusedGeom(h=h, w=wd, cin=cin, nc=nc, kth=kth, ktw=ktw, sh=sh,
                     sw=sw, out_h=oh, out_w=ow, res_h=res_h, res_w=res_w,
                     dtype="int8")
    plan = plan if plan is not None else heuristic_plan(geom)
    if smem_bytes(geom, plan) > SMEM_BUDGET:
        raise ValueError(f"tile {plan} needs {smem_bytes(geom, plan)} bytes "
                         f"of shared memory; a block has {SMEM_BUDGET}")
    return LaunchGeometry(
        q_h=q_h, q_w=q_w, plo_h=plo_h, plo_w=plo_w, res_h=res_h,
        res_w=res_w, out_h=oh, out_w=ow, nh=-(-oh // (plan.th * sh)),
        nw=-(-ow // (plan.tw * sw)), plan=plan)


@dataclass(frozen=True)
class GemmLaunch:
    """The integers K1's float branch is handed for one launch: the crop
    origin of :func:`_crop_origin`, the output shape, the ``mh x mw``
    conv positions per sample that the cropped output needs (``mh =
    ceil((out_h + res_h) / sh)``; the GEMM's rows are ``B * mh * mw``),
    the GEMM geometry and its :class:`GemmPlan`."""
    q_h: int
    q_w: int
    plo_h: int
    plo_w: int
    res_h: int
    res_w: int
    out_h: int
    out_w: int
    mh: int
    mw: int
    geom: GemmGeom
    plan: GemmPlan


def gemm_launch(x_shape, ws_shape, s, pad, crop, out_space,
                plan: Optional[GemmPlan] = None,
                dtype: str = "") -> GemmLaunch:
    sh, sw = _pair(s)
    b, _, _, cin = x_shape
    kth, ktw, _, nc = ws_shape
    oh, ow = out_space
    q_h, q_w, plo_h, plo_w, res_h, res_w = _crop_origin(s, pad, crop)
    mh, mw = -(-(oh + res_h) // sh), -(-(ow + res_w) // sw)
    geom = GemmGeom(m=b * mh * mw, n=nc, k=kth * ktw * cin, dtype=dtype)
    plan = plan if plan is not None else gemm_plan(geom)
    check_gemm_plan(geom, plan)
    return GemmLaunch(q_h=q_h, q_w=q_w, plo_h=plo_h, plo_w=plo_w,
                      res_h=res_h, res_w=res_w, out_h=oh, out_w=ow, mh=mh,
                      mw=mw, geom=geom, plan=plan)


def check_plan_type(what: str, plan, gemm: bool) -> None:
    """The float fused kernels (K1's float branch, K2 in f32) take a
    :class:`GemmPlan` (``gemm``), the int8 ones and K4 a
    :class:`KernelPlan`; raise ``TypeError`` on the other.  ``what``
    names the launch or plan in the message."""
    want = GemmPlan if gemm else KernelPlan
    if plan is not None and not isinstance(plan, want):
        raise TypeError(f"{what} takes a {want.__name__}, got "
                        f"{type(plan).__name__}")


def _check_cuda_operands(x, ws, bias, sh, sw):
    if x.dtype not in DTYPES and x.dtype != torch.int8:
        raise TypeError(f"sd_fused kernel takes float32, bfloat16 or int8 "
                        f"input, got {x.dtype}")
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
             plan: Optional[Union[GemmPlan, KernelPlan]] = None,
             scale: Optional[torch.Tensor] = None,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused SD, zero-copy: split-filter conv + interleaved write.

    x: (B, H, W, Cin) unpadded; ``pad`` (the ``P_I`` halo) is applied in
    the kernel by masked reads.  ws_ocmajor: (KTh, KTw, Cin, Cout*sh*sw),
    channel ``oc*sh*sw + phase``.  ``s``: an int or ``(sh, sw)``.  bias:
    (Cout,), added in f32.  crop: low-side crop per dim in interleaved
    coordinates.  out_space: final output spatial shape (rows past the
    shuffled support come out as ``act(bias)``); defaults to the
    uncropped interleave.  Returns (B, *out_space, Cout) in ``x.dtype``.
    ``plan``: a float launch's :class:`GemmPlan` (default
    :func:`~repro_torch.kernels.autotune.gemm_plan`), an int8 launch's
    :class:`KernelPlan` (default ``heuristic_plan``); the other type
    raises ``TypeError``.  A float launch with ``splits > 1`` is two
    kernels (the split GEMM, the ordered sum with the epilogue), counted
    as one launch.

    int8 branch: ``x`` and ``ws_ocmajor`` int8 and ``scale`` the f32
    combined dequant scale, oc-major like the filters: (B, Cout*sh*sw)
    (sample ``b``'s activation scale times each phase channel's filter
    scale), or a static (1, Cout*sh*sw) row that every sample reads in
    place (the kernel is handed a batch stride of 0).  ``out_dtype``:
    f32 (or None), or int8 for the chained epilogue (linear or relu;
    ``scale`` and ``bias`` carry the next layer's ``1/sx``): round half
    to even, clamp to +-127, int8 out.
    """
    global SD_FUSED_LAUNCHES, SD_FUSED_INT8_LAUNCHES
    sh, sw = _pair(s)
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    if out_space is None:
        out_space = _full_space(x.shape, ws_ocmajor.shape, s, pad)
    qdtype = quant_contract(x, ws_ocmajor, scale, out_dtype, act)
    quant = qdtype is not None
    check_plan_type(f"sd_fused: a{'n int8' if quant else ' float'} launch",
                    plan, gemm=not quant)
    if x.device.type == "cpu":
        return sd_fused_ref(x, ws_ocmajor, s, bias=bias, act=act, pad=pad,
                            crop=crop, out_space=out_space, scale=scale,
                            out_dtype=qdtype)
    if x.device.type != "cuda":
        raise ValueError(f"sd_fused runs on cuda or cpu, not {x.device}")
    check_no_grad("sd_fused", x, ws_ocmajor, bias, scale)
    cout = ws_ocmajor.shape[-1] // (sh * sw)
    if bias is None:
        bias = torch.zeros(cout, device=x.device)
    bias = bias.float().contiguous()
    _check_cuda_operands(x, ws_ocmajor, bias, sh, sw)
    b, h, wd, cin = x.shape
    y = torch.empty((b, *out_space, cout),
                    dtype=qdtype if quant else x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    from repro_torch.kernels.build import load
    if quant:
        g = launch_geometry(x.shape, ws_ocmajor.shape, (sh, sw), pad, crop,
                            out_space, plan)
        if g.nh * g.nw > 65535:
            raise ValueError(f"{g.nh * g.nw} spatial tiles exceed the "
                             "grid's y limit; use a larger tile")
        p = g.plan
        fn = load("sd_fused_int8").fn
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), ws_ocmajor.data_ptr(), scale.data_ptr(),
                     bias.data_ptr(), y.data_ptr(), b, h, wd, cin, cout,
                     ws_ocmajor.shape[0], ws_ocmajor.shape[1], sh, sw,
                     g.q_h, g.q_w, g.plo_h, g.plo_w, g.res_h, g.res_w,
                     g.out_h, g.out_w, p.th, p.tw, p.tcin, p.tc, ACTS[act],
                     0 if scale.shape[0] == 1 else scale.shape[1],
                     int(qdtype == torch.int8), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"sd_fused int8 kernel launch failed: CUDA "
                               f"error {err}")
        SD_FUSED_INT8_LAUNCHES += 1
        return y
    g = gemm_launch(x.shape, ws_ocmajor.shape, (sh, sw), pad, crop,
                    out_space, plan,
                    dtype="bf16" if x.dtype == torch.bfloat16 else "")
    p = g.plan
    work = _split_workspace(g.geom, p, x.device)
    fn = load("sd_fused").fn
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), ws_ocmajor.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), None if work is None else work.data_ptr(),
                 DTYPES[x.dtype], b, h, wd, cin, cout,
                 ws_ocmajor.shape[0], ws_ocmajor.shape[1], sh, sw,
                 g.q_h, g.q_w, g.plo_h, g.plo_w, g.res_h, g.res_w,
                 g.out_h, g.out_w, p.bn, p.splits,
                 ACTS[act], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sd_fused kernel launch failed: CUDA error {err}")
    SD_FUSED_LAUNCHES += 1          # the GEMM and, split, its reduce: one
    return y


def _split_workspace(geom: GemmGeom, plan: GemmPlan, device
                     ) -> Optional[torch.Tensor]:
    """The split-K partial slabs ``(splits, M, N)`` f32, or None for one
    split (the GEMM kernel then runs the epilogue itself)."""
    if plan.splits == 1:
        return None
    return torch.empty((plan.splits, geom.m, geom.n), dtype=torch.float32,
                       device=device)


# ---------------------------------------------------------------------------
# K2: stride-1 VALID conv with in-kernel pad and an output window
# ---------------------------------------------------------------------------

def _conv_window(x_shape, w_shape, pad, out_start, out_size):
    """Size of the output window ``(out_start, out_size)`` (default: the
    whole conv output over the padded input), checked to lie inside the
    conv output."""
    (plo_h, phi_h), (plo_w, phi_w) = pad
    full = (x_shape[1] + plo_h + phi_h - w_shape[0] + 1,
            x_shape[2] + plo_w + phi_w - w_shape[1] + 1)
    size = tuple(out_size) if out_size is not None else full
    if min(pad[0] + pad[1]) < 0 or any(
            o < 0 or o + n > f for o, n, f in zip(out_start, size, full)):
        raise ValueError(f"output window {tuple(out_start)}+{size} is not "
                         f"inside the conv output {full} (pad {pad})")
    return size


def sd_conv_ref(x: torch.Tensor, w: torch.Tensor,
                pad: Tuple[PadPair, PadPair] = ((0, 0), (0, 0)),
                out_start: Tuple[int, int] = (0, 0),
                out_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`sd_conv`: ``F.pad``, ``F.conv2d``
    in f32, the window slice, cast to ``x.dtype``.  On an int8 pair: the
    zero-padded input cut to the window's rows and columns, summed
    exactly (:func:`exact_conv_valid`), int32 out."""
    oh, ow = _conv_window(x.shape, w.shape, pad, out_start, out_size)
    (plo_h, phi_h), (plo_w, phi_w) = pad
    (sh, sw) = out_start
    if x.dtype == torch.int8:
        xp = F.pad(x, (0, 0, plo_w, phi_w, plo_h, phi_h))
        xp = xp[:, sh:sh + oh + w.shape[0] - 1, sw:sw + ow + w.shape[1] - 1]
        return exact_conv_valid(xp, w).to(torch.int32)
    xp = F.pad(x.float(), (0, 0, plo_w, phi_w, plo_h, phi_h))
    y = conv_valid(xp, w.float())
    return y[:, sh:sh + oh, sw:sw + ow].to(x.dtype)


def _check_operands(name: str, dtype: torch.dtype, *ts: torch.Tensor
                    ) -> None:
    for t in ts:
        if t.dtype != dtype:
            raise TypeError(f"{name} kernel takes {dtype}, got {t.dtype}")
        if t.device != ts[0].device:
            raise ValueError(f"{name} operands must share one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")


def _conv_int8_contract(x: torch.Tensor, w: torch.Tensor,
                        sum_terms: Optional[int]) -> bool:
    """True for K2's int8 pair, checked on any device: both operands
    int8, and the whole int32 sum (``sum_terms`` products, default this
    launch's ``Cin * KTh * KTw``; the 3-D lowering adds its depth taps
    outside the kernel) below 2^31."""
    if x.dtype != torch.int8 and w.dtype != torch.int8:
        if sum_terms is not None:
            raise ValueError("sum_terms bounds an int8 pair's int32 sum")
        return False
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"K2's int8 branch takes an int8 (x, w) pair, got "
                        f"{x.dtype} and {w.dtype}")
    own = x.shape[3] * w.shape[0] * w.shape[1]
    terms = own if sum_terms is None else int(sum_terms)
    if terms < own:
        raise ValueError(f"sum_terms {terms} is below this launch's own "
                         f"Cin x taps = {own}")
    check_int32_terms(terms, "an int8 conv over Cin x taps")
    return True


def sd_conv(x: torch.Tensor, w: torch.Tensor, *,
            pad: Tuple[PadPair, PadPair] = ((0, 0), (0, 0)),
            out_start: Tuple[int, int] = (0, 0),
            out_size: Optional[Tuple[int, int]] = None,
            plan: Optional[Union[GemmPlan, KernelPlan]] = None,
            sum_terms: Optional[int] = None) -> torch.Tensor:
    """Stride-1 VALID conv over the logically zero-padded input (K2).

    x: (B, H, W, Cin) unpadded; ``pad`` is applied in the kernel by
    masked reads.  w: (KTh, KTw, Cin, Co), rectangular allowed.
    ``out_start``/``out_size`` select a window of the conv output (in
    padded-input coordinates; default the whole output), so a crop
    after the conv folds into the launch.  Returns (B, *out_size, Co).
    ``plan``: in f32 a :class:`GemmPlan` (default
    :func:`~repro_torch.kernels.autotune.gemm_plan`; with ``splits > 1``
    the split GEMM and its ordered sum, counted as one launch), for the
    int8 pair a :class:`KernelPlan` (default
    :func:`~repro_torch.kernels.autotune.conv_plan`); the other type
    raises ``TypeError``.

    An int8 ``(x, w)`` pair returns the exact int32 conv (the halo is
    the int8 zero); ``sum_terms`` is the number of int8 products in each
    element's whole sum when the caller adds several launches (the 3-D
    lowering: ``Cin * KT_d * KT_h * KT_w``), and a sum that could reach
    2^31 raises.  Operands that require grad under grad mode raise on
    the card (:func:`check_no_grad`): the int8 branch is inference-only.
    """
    global SD_CONV_LAUNCHES, SD_CONV_INT8_LAUNCHES
    if x.ndim != 4 or w.ndim != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)} "
                         "are not (B,H,W,Cin), (KTh,KTw,Cin,Co)")
    oh, ow = _conv_window(x.shape, w.shape, pad, out_start, out_size)
    quant = _conv_int8_contract(x, w, sum_terms)
    check_plan_type(f"sd_conv: a{'n int8' if quant else ' float'} launch",
                    plan, gemm=not quant)
    if x.device.type == "cpu":
        return sd_conv_ref(x, w, pad, out_start, (oh, ow))
    if x.device.type != "cuda":
        raise ValueError(f"sd_conv runs on cuda or cpu, not {x.device}")
    if quant:
        check_no_grad("sd_conv", x, w)
    _check_operands("sd_conv", torch.int8 if quant else torch.float32, x, w)
    b, h, wd, cin = x.shape
    kth, ktw, _, co = w.shape
    geom = ConvGeom(h=h, w=wd, cin=cin, co=co, kth=kth, ktw=ktw, out_h=oh,
                    out_w=ow, dtype="int8" if quant else "")
    y = torch.empty((b, oh, ow, co),
                    dtype=torch.int32 if quant else x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    from repro_torch.kernels.build import load
    (plo_h, _), (plo_w, _) = pad
    if not quant:
        gg = geom.as_gemm(b)
        plan = plan if plan is not None else gemm_plan(gg)
        check_gemm_plan(gg, plan)
        work = _split_workspace(gg, plan, x.device)
        fn = load("sd_conv").fn
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                     None if work is None else work.data_ptr(), b, h, wd,
                     cin, co, kth, ktw, plo_h, plo_w, out_start[0],
                     out_start[1], oh, ow, plan.bn, plan.splits,
                     ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"sd_conv kernel launch failed: CUDA error "
                               f"{err}")
        SD_CONV_LAUNCHES += 1       # the GEMM and, split, its reduce: one
        return y
    plan = plan if plan is not None else conv_plan(geom)
    smem = smem_bytes(geom.as_fused(), plan)
    if smem > SMEM_BUDGET:
        raise ValueError(f"tile {plan} needs {smem} bytes of shared memory; "
                         f"a block has {SMEM_BUDGET}")
    tiles = -(-oh // plan.th) * -(-ow // plan.tw)
    if tiles > 65535 or b > 65535:
        raise ValueError(f"{tiles} spatial tiles x batch {b} exceed the "
                         "grid's limits; use a larger tile")
    fn = load("sd_conv_int8").fn
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, cin,
                 co, kth, ktw, plo_h, plo_w, out_start[0], out_start[1],
                 oh, ow, plan.th, plan.tw, plan.tcin, plan.tc,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sd_conv int8 kernel launch failed: CUDA error "
                           f"{err}")
    SD_CONV_INT8_LAUNCHES += 1
    return y


# ---------------------------------------------------------------------------
# K3: the filter gradient, P_I pad in the kernel, deterministic split-M
# ---------------------------------------------------------------------------

def _filter_grad_geom(x_shape, dy_shape, kt, pad) -> FilterGradGeom:
    b, h, wd, cin = x_shape
    (plo_h, phi_h), (plo_w, phi_w) = pad
    o1h, o1w = h + plo_h + phi_h - kt[0] + 1, wd + plo_w + phi_w - kt[1] + 1
    if (len(dy_shape) != 4 or tuple(dy_shape[:3]) != (b, o1h, o1w)
            or min(pad[0] + pad[1]) < 0):
        raise ValueError(f"dy1 {tuple(dy_shape)} does not match x "
                         f"{tuple(x_shape)} padded by {pad} under {kt} taps "
                         f"(expected (B, {o1h}, {o1w}, NCo))")
    return FilterGradGeom(b=b, h=h, w=wd, cin=cin, nco=dy_shape[3],
                          kth=kt[0], ktw=kt[1], o1h=o1h, o1w=o1w)


def sd_filter_grad_ref(x: torch.Tensor, dy1: torch.Tensor, kt,
                       pad: Tuple[PadPair, PadPair] = ((0, 0), (0, 0))
                       ) -> torch.Tensor:
    """Plain PyTorch version of :func:`sd_filter_grad`: ``F.pad`` and the
    batch/channel-exchanged VALID conv, in f32, cast to ``dy1.dtype``."""
    _filter_grad_geom(x.shape, dy1.shape, _pair(kt), pad)
    (plo_h, phi_h), (plo_w, phi_w) = pad
    xp = F.pad(x.float(), (0, 0, plo_w, phi_w, plo_h, phi_h))
    return conv_valid_filter_grad(xp, dy1.float()).to(dy1.dtype)


def sd_filter_grad(x: torch.Tensor, dy1: torch.Tensor, kt, *,
                   pad: Tuple[PadPair, PadPair] = ((0, 0), (0, 0)),
                   plan: Optional[FilterGradPlan] = None) -> torch.Tensor:
    """Gradient of ``y1 = conv_valid(pad(x), ws)`` w.r.t. ``ws`` (K3).

    x: (B, H, W, Cin) *unpadded* (``pad`` is applied in the kernel);
    dy1: (B, O1h, O1w, NCo) with ``O1 = H + pad - KT + 1`` per dim; kt:
    ``(KTh, KTw)``.  Returns dws: (KTh, KTw, Cin, NCo).  ``plan``: the
    channel tile and reduction chunk; default
    :func:`~repro_torch.kernels.autotune.filter_grad_plan`.
    """
    global SD_FILTER_GRAD_LAUNCHES
    kt = _pair(kt)
    geom = _filter_grad_geom(x.shape, dy1.shape, kt, pad)
    if x.device.type == "cpu":
        return sd_filter_grad_ref(x, dy1, kt, pad)
    if x.device.type != "cuda":
        raise ValueError(f"sd_filter_grad runs on cuda or cpu, not "
                         f"{x.device}")
    _check_operands("sd_filter_grad", torch.float32, x, dy1)
    plan = plan if plan is not None else filter_grad_plan(geom)
    out = torch.empty((*kt, geom.cin, geom.nco), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    if geom.m == 0:
        return out.zero_()
    splits = dw_splits(geom, plan)
    nci = -(-geom.cin // DW_TCI)
    if splits > 65535 or kt[0] * kt[1] * nci > 65535:
        raise ValueError(f"{splits} chunks or {kt[0] * kt[1] * nci} "
                         "tap tiles exceed the grid's limits")
    part = (torch.empty((splits, *out.shape), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    from repro_torch.kernels.build import load
    fn = load("sd_filter_grad").fn
    (plo_h, _), (plo_w, _) = pad
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dy1.data_ptr(),
                 None if part is None else part.data_ptr(), out.data_ptr(),
                 geom.b, geom.h, geom.w, geom.cin, geom.nco, kt[0], kt[1],
                 plo_h, plo_w, geom.o1h, geom.o1w, plan.tco, plan.chunk,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sd_filter_grad kernel launch failed: CUDA "
                           f"error {err}")
    SD_FILTER_GRAD_LAUNCHES += 1
    return out
