"""K5: flash attention (forward) and its plain PyTorch version.

:func:`flash_attention` has the contract of the TPU kernel
``flash_attention`` (``src/repro/kernels/flash_attn.py``): q/k/v ``(B, H,
S, D)``, softmax attention with an online softmax (running max, sum and
accumulator in f32), ``scale = 1/sqrt(D)`` applied to q, a causal launch
only for ``Sq == Sk`` (the TPU kernel's own validity note: its
start-aligned mask is then the end-aligned one), tiles entirely above the
diagonal skipped, the output in ``q.dtype``.  Beyond that contract it
takes k/v with ``Hkv`` heads, ``H % Hkv == 0`` (q head ``h`` reads kv
head ``h // (H // Hkv)``), any ``S >= 1`` (keys past ``Sk`` masked, rows
past ``Sq`` never written, no padding copy), and any strides over
(batch, head, sequence) with a unit-stride head dim; the output has q's
strides when q is dense (a transposed view of (B, S, H, D) activations),
else it is contiguous.

On a CUDA tensor it launches ``csrc/flash_attn.cu`` (built at first use;
counted by ``FLASH_ATTN_LAUNCHES``) or raises: bf16 runs the ``wgmma``
kernel fed by TMA (tile :data:`TILE`), which needs q, k and v on 16-byte
boundaries with every stride over (batch, head, sequence) a multiple of
16 bytes; f32 runs both products on the TF32 tensor cores in 3xTF32
(``mma.sync``, every operand split hi/lo, k/v fed by a ``cp.async`` ring;
tile :data:`F32_TILE`, :data:`F32_TILE_WIDE` past ``F32_WIDE_D`` head
dims), which takes any such strides (16-byte copies where they and the
base allow them, 4-byte ones otherwise).  On a CPU tensor it runs
:func:`flash_attention_ref`, the reference's oracle
(``src/repro/kernels/ref.py`` ``flash_attention_ref``: full f32 scores,
end-aligned causal mask, optional window), which the tests and
``chip_smoke.py`` also hold the kernel against.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.sd_conv import check_no_grad

TILE = (128, 64)           # the bf16 kernel's (query rows, keys) per step
F32_TILE = (128, 32)       # the f32 kernel's: 8 warps of 16 query rows
F32_TILE_WIDE = (64, 32)   # past F32_WIDE_D: 4 warps, so q and 2 stages fit
F32_WIDE_D = 192
MAX_HEAD_DIM = 256         # the kernels' shared-memory staging holds D <= 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TMA_ALIGN = 16             # bytes: a TMA map's base and strides

FLASH_ATTN_LAUNCHES = 0    # kernel launches; the plain versions never count


def _gqa_expand(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    g = q.shape[1] // k.shape[1]
    if g == 1:
        return k, v
    return k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Softmax attention oracle.  q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D)
    with ``H % Hkv == 0`` (the reference takes them already expanded).
    f32 scores over the whole sequence, the mask aligned at the ends
    (decode style), output in ``q.dtype``."""
    k, v = _gqa_expand(q, k, v)
    qf, kf, vf = (t.float() for t in (q, k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", qf * scale, kf)
    sq, sk = q.shape[2], k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def kernel_tile(dtype: torch.dtype, d: int) -> tuple:
    """(query rows, keys) per step of the kernel that runs ``dtype`` at
    head dim ``d``."""
    if dtype == torch.bfloat16:
        return TILE
    return F32_TILE if d <= F32_WIDE_D else F32_TILE_WIDE


def _check_operands(q, k, v, causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B, H, Sq, D), "
                         "(B, Hkv, Sk, D) twice")
    (b, h, sq, d), (bk_, hkv, sk, dk) = q.shape, k.shape
    if b != bk_ or d != dk:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads do not divide into {hkv} kv "
                         "heads")
    if sq < 1 or sk < 1 or d < 1:
        raise ValueError(f"empty attention: Sq {sq}, Sk {sk}, D {d}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must share one device")
    if causal and sq != sk:
        raise ValueError(f"a causal launch needs Sq == Sk, not {sq} and "
                         f"{sk}")


def _tma_strides(name: str, t: torch.Tensor) -> tuple:
    """t's (batch, head, sequence) strides as the bf16 kernel's TMA map
    takes them, a size-1 dim's stride (never stepped over) replaced by a
    valid one; raises where a map cannot describe t."""
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"the bf16 kernel reads {name} by TMA, which needs "
                         f"a base on a {TMA_ALIGN}-byte boundary, not "
                         f"{t.data_ptr():#x}")
    unit = TMA_ALIGN // t.element_size()
    (b, h, s, d), (sb, sh, ss) = t.shape, t.stride()[:3]
    for dim, n, x in (("batch", b, sb), ("head", h, sh),
                      ("sequence", s, ss)):
        if n > 1 and (x <= 0 or x % unit):
            raise ValueError(
                f"the bf16 kernel reads {name} by TMA, which needs its "
                f"{dim} stride to be a positive multiple of {TMA_ALIGN} "
                f"bytes ({unit} elements), not {x}")
    ss = ss if s > 1 else -(-d // unit) * unit
    sh = sh if h > 1 else ss * s
    sb = sb if b > 1 else sh * h
    return sb, sh, ss


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: Optional[int] = None,
                    bk: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D), ``H % Hkv == 0``, ``Sq ==
    Sk`` when ``causal``.

    Returns (B, H, Sq, D) in ``q.dtype`` (q's strides when q is dense).
    ``bq``/``bk`` are the TPU kernel's tiles: any positive sizes on the
    CPU, where they do not change the result; on the card the kernel's
    own (:func:`kernel_tile`: ``TILE`` for bfloat16, ``F32_TILE`` or
    ``F32_TILE_WIDE`` for float32), which is what ``None`` picks.  The
    kernels take float32 or bfloat16 and ``D <= MAX_HEAD_DIM``; bfloat16
    also needs TMA-describable operands (:func:`_tma_strides`).
    """
    global FLASH_ATTN_LAUNCHES
    _check_operands(q, k, v, causal)
    if (bq is not None and bq < 1) or (bk is not None and bk < 1):
        raise ValueError(f"tiles ({bq}, {bk}) must be positive")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not "
                        f"{q.dtype}")
    d = q.shape[-1]
    tile = kernel_tile(q.dtype, d)
    if (bq or tile[0], bk or tile[1]) != tile:
        raise ValueError(f"the {q.dtype} kernel's tile is {tile}, not "
                         f"({bq}, {bk})")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be unit-stride")
    if q.shape[1] > 65535 or q.shape[0] > 65535:
        raise ValueError(f"{q.shape[0]} x {q.shape[1]} (batch x heads) "
                         "exceeds the grid's limit of 65535 each")
    check_no_grad("flash_attention", q, k, v)
    if q.dtype == torch.bfloat16:
        strides = [_tma_strides(n, t) for n, t in (("q", q), ("k", k),
                                                   ("v", v))]
    else:
        strides = [t.stride()[:3] for t in (q, k, v)]
    out = torch.empty_like(q)       # q's strides when q is dense
    from repro_torch.kernels.build import load
    fn = load("flash_attn").fn
    b, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 DTYPES[q.dtype], b, h, hkv, sq, sk, d, int(causal),
                 *strides[0], *strides[1], *strides[2],
                 *out.stride()[:3], ctypes.c_float(1.0 / math.sqrt(d)),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    FLASH_ATTN_LAUNCHES += 1
    return out
