"""The backward pass of split deconvolution, as stride-1 convolutions.

The port of ``repro.sd.grad``.  The forward is

    xp  = pad(x, P_I)
    y1  = conv_valid(xp, ws)          ws = split_filters(w)
    ps  = depth_to_space(y1)
    y   = crop(ps, P_K + user padding, + output_padding)

and each step is linear, so the gradient is the chain of adjoints: crop^T
(zero-embed ``dy``; the cotangent of ``output_padding`` rows past the
shuffled support is dropped), ``space_to_depth``, the input grad of the
stride-1 conv (a FULL conv with the split filters rotated 180 degrees
and their channels swapped), its filter grad (a VALID conv with batch
and channel axes exchanged), ``unsplit_filters``, and pad^T.

A ``fused`` or ``winograd`` plan of rank 1 or 2 runs the two
convolutions on the hand-written kernels: K2 for ``dx`` (the FULL-conv
pad is masked reads and pad^T is the launch's output window) and K3 for
``dw`` (``P_I`` applied in the kernel); rank 1 as H=1 launches
(``dy1[:, None]``, ``ws[None]``, taps ``(1, KT)``, pad ``(0, P_I)``,
window ``(1, L)``), as the reference lowers it.  A Winograd forward
splits the same filters as K1's, so its backward is the same pair of
convolutions; this is where the port departs from the reference, which
sends its ``winograd`` plans to its lax formulations: a ``fused``
engine binds a layer to ``winograd`` wherever K4 measured faster, and
that layer's training step must stay on the card's kernels.  A
``torch`` plan, and every rank-3 plan, runs the ``F.conv``-based
formulations below.

A Cout-sharded plan (``plan.shards > 1``, under
:func:`~repro_torch.distributed.spmd`): ``w`` is the rank's Cout block
and ``dy`` the cotangent of the gathered output, whole on every rank of
the shard axis.  The gather's adjoint is a slice, so the rank takes its
block of ``dy`` (from ``model_index * coutl``) and runs the same local
backward: ``dw`` stays on the shard (on the kernels K3 runs on the local
``dy1``, ``phases * coutl`` channels), and ``dx``, a sum over every
output channel, is K2 on the local filters followed by one all-reduce
over the shard axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.deconv import (conv_valid, conv_valid_filter_grad,
                                     sd_geometry, space_to_depth,
                                     split_filters, unsplit_filters)
from repro_torch.sd.plan import DeconvPlan


def _pad_spatial(t: torch.Tensor, pads) -> torch.Tensor:
    """Zero-pad the spatial dims of a channels-last tensor by per-dim
    ``(lo, hi)`` pairs."""
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(t, flat)


def _conv_valid_input_grad(dy1: torch.Tensor,
                           ws: torch.Tensor) -> torch.Tensor:
    """Gradient of ``y1 = conv_valid(xp, ws)`` w.r.t. ``xp``, any rank: a
    FULL stride-1 conv with the spatially rotated, channel-swapped
    filters."""
    rank = dy1.ndim - 2
    kt = ws.shape[:rank]
    w_t = ws.flip(tuple(range(rank))).transpose(-1, -2)
    return conv_valid(_pad_spatial(dy1, [(k - 1, k - 1) for k in kt]), w_t)


def split_cotangent(plan: DeconvPlan, dy: torch.Tensor) -> torch.Tensor:
    """crop^T then d2s^T: the cotangent of the split conv's output
    ``y1`` (B, *O1, prod(s)*Cout), n-major, from the deconv's ``dy``."""
    _, pk, _ = sd_geometry(plan.kernel, plan.stride)
    pads = []
    for i, ((lo, hi), opi) in enumerate(zip(plan.padding,
                                            plan.output_padding)):
        trail = hi - opi
        if trail < 0:       # the forward zero-extended these rows
            dy = dy.narrow(1 + i, 0, dy.shape[1 + i] + trail)
            trail = 0
        pads.append((pk[i] + lo, trail))
    return space_to_depth(_pad_spatial(dy, pads), plan.stride).contiguous()


def conv_transpose_vjp(plan: DeconvPlan, x: torch.Tensor, w: torch.Tensor,
                       dy: torch.Tensor, mesh=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` for ``y = conv_transpose(plan, x, w)``.  Both
    gradients are computed over the split layout: the cotangent is
    pixel-unshuffled once and the two convolutions run on ``K_T``-tap
    stride-1 geometry, with no inserted zeros.  ``mesh``: a sharded
    plan's mesh (default: the active :func:`~repro_torch.distributed.spmd`
    one; autograd may run a CUDA backward on another thread, so
    ``conv_transpose`` passes the forward's)."""
    rank = plan.rank
    kt, _, pi = sd_geometry(plan.kernel, plan.stride)
    space = tuple(x.shape[1:1 + rank])
    ws = split_filters(w, plan.stride)
    if plan.shards > 1:
        if mesh is None:
            from repro_torch.sd.functional import shard_mesh
            mesh = shard_mesh(plan)
        coutl = w.shape[-1]                  # all_gather^T: a slice
        dy = dy.narrow(dy.ndim - 1,
                       mesh.axis_index(plan.shard_axis) * coutl, coutl)
    dy1 = split_cotangent(plan, dy)
    on_kernels = plan.backend in ("fused", "winograd")
    if on_kernels and rank == 2:
        from repro_torch.kernels import ops
        dx = ops.sd_input_grad_fused(dy1, ws.to(dy1.dtype), pi, space)
        dws = ops.sd_filter_grad_fused(x.contiguous(), dy1, kt, pi)
    elif on_kernels and rank == 1:
        from repro_torch.kernels import ops
        dx = ops.sd_input_grad_fused(dy1[:, None], ws.to(dy1.dtype)[None],
                                     (0, pi[0]), (1, space[0]))[:, 0]
        dws = ops.sd_filter_grad_fused(x.contiguous()[:, None],
                                       dy1[:, None], (1, kt[0]),
                                       (0, pi[0]))[0]
    else:
        dxp = _conv_valid_input_grad(dy1, ws.to(dy1.dtype))
        dx = dxp[(slice(None),)                     # pad^T
                 + tuple(slice(p, p + n) for p, n in zip(pi, space))]
        dws = conv_valid_filter_grad(
            _pad_spatial(x, [(p, p) for p in pi]), dy1)
    dw = unsplit_filters(dws, plan.kernel, plan.stride)      # split^T
    if plan.shards > 1:           # dx sums over every output channel
        dx = mesh.all_reduce(dx, plan.shard_axis)
    return dx.to(x.dtype), dw.to(w.dtype)
