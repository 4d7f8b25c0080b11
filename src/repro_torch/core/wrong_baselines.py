"""Prior deconv-to-conv conversions the paper compares against (Table 4).

The port of the JAX package's ``core/wrong_baselines.py``.  Both are
*incorrect* in general — that is the paper's point — and both reproduce
the reference's wrong output, not a correct one, so that the SSIM
comparison quantifies the same damage:

* ``shi_deconv``   — Shi et al. [30]: sub-pixel conversion with the
  filter's zero expansion on the bottom/right, the input padded by
  ``2 * P_I`` on the right/bottom only, and the interleaved output cropped
  from the origin.  Only the first partition's geometry is right; when
  ``K % s != 0`` every other phase reads shifted windows.
* ``chang_deconv`` — Chang & Kang [31]: the kernel truncated to ``K - K %
  s`` so that it splits evenly, dropping the boundary taps, and the
  output cropped with a clamp.

``chang_deconv`` is exact when ``s | K`` (it then delegates to
:func:`~repro_torch.core.deconv.sd_deconv`); ``shi_deconv``'s crop from
the origin ignores the user padding whatever ``K``.  The paper evaluates
both on DCGAN (K=5, s=2) and FST (K=3, s=2), where ``K % s != 0``.  2-D,
NHWC, filters ``(K, K, Cin, Cout)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.deconv import (_ntuple, _pads_nd, conv_valid,
                                     deconv_output_shape, depth_to_space,
                                     sd_deconv, sd_geometry)


def _window(t: torch.Tensor, starts, sizes) -> torch.Tensor:
    """``t[:, st:st+n, ...]`` per spatial dim; raises where the window
    leaves ``t``, as the reference's ``lax.slice`` does."""
    for i, (st, n) in enumerate(zip(starts, sizes)):
        if st < 0 or st + n > t.shape[1 + i]:
            raise ValueError(f"window {tuple(starts)} + {tuple(sizes)} "
                             f"leaves the output {tuple(t.shape)}")
    return t[(slice(None),) + tuple(slice(st, st + n)
                                    for st, n in zip(starts, sizes))]


def _split_with_expansion(w: torch.Tensor, stride,
                          expand_side: str) -> torch.Tensor:
    """Split filters (n-major) with the zero expansion on a chosen side:
    ``"top_left"`` is the paper's SD, anything else Shi's bottom/right."""
    sh, sw = _ntuple(stride, 2)
    kh, kw, cin, cout = w.shape
    (kth, ktw), (pkh, pkw), _ = sd_geometry((kh, kw), (sh, sw))
    if expand_side == "top_left":
        we = F.pad(w, (0, 0, 0, 0, pkw, 0, pkh, 0))
    else:
        we = F.pad(w, (0, 0, 0, 0, 0, pkw, 0, pkh))
    we = we.reshape(kth, sh, ktw, sw, cin, cout).flip((0, 2))
    return we.permute(0, 2, 4, 1, 3, 5).reshape(kth, ktw, cin,
                                                sh * sw * cout)


def shi_deconv(x: torch.Tensor, w: torch.Tensor, stride,
               padding=0) -> torch.Tensor:
    """[30]'s conversion: fixed right/bottom input padding, fixed crop
    from the origin, which ignores both ``P_K`` and the user padding."""
    _, _, (pih, piw) = sd_geometry(tuple(w.shape[:2]), stride)
    out = deconv_output_shape(x.shape[1:3], tuple(w.shape[:2]), stride,
                              padding)
    ws = _split_with_expansion(w, stride, "bottom_right")
    xp = F.pad(x, (0, 0, 0, 2 * piw, 0, 2 * pih))
    ps = depth_to_space(conv_valid(xp, ws), _ntuple(stride, 2))
    return ps[:, :out[0], :out[1]]      # never past ps: K - p <= K_T * s


def chang_deconv(x: torch.Tensor, w: torch.Tensor, stride,
                 padding=0) -> torch.Tensor:
    """[31]'s approximate conversion: drop the first ``K % s`` rows and
    columns of the filter so that ``s | K``, run the (now exact) split at
    zero padding, and crop the requested size at ``max(p_lo - K % s, 0)``,
    clamped into the output."""
    sh, sw = _ntuple(stride, 2)
    kh, kw = w.shape[:2]
    dh, dw = kh % sh, kw % sw
    if dh == 0 and dw == 0:
        return sd_deconv(x, w, stride, padding)
    (pt, _), (pl, _) = _pads_nd(padding, 2)
    oh, ow = deconv_output_shape(x.shape[1:3], (kh, kw), stride, padding)
    full = sd_deconv(x, w[dh:, dw:], stride, 0)
    st = min(max(pt - dh, 0), max(full.shape[1] - oh, 0))
    sl = min(max(pl - dw, 0), max(full.shape[2] - ow, 0))
    return _window(full, (st, sl), (oh, ow))
