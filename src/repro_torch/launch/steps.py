"""Step functions of LM training and serving.

The port of ``effective_seq``, ``make_train_step``, ``make_prefill_step``
and ``make_decode_step`` of the JAX package's ``launch/steps.py``.
PyTorch runs eagerly, so a step is the plain callable the reference
would ``jax.jit``.  Every LM that ``build_lm`` builds runs through them:
attention decoders, dense or MoE, xLSTM, Jamba, and with their
embeddings in the batch (``patch_embeds``, ``frame_embeds``) InternVL2
and Whisper.  The reference's abstract input specs (``input_specs``,
``abstract_*``) serve its dry-run lowering and are not ported (ROADMAP.md
item 16.5).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models.lm import LM
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               cosine_warmup_schedule)
from repro_torch.optim.adamw import _leaves, _map, _unflatten


def effective_seq(cfg: ArchConfig, cell: ShapeCell) -> int:
    """Clamp the cell's sequence length to the arch's positional limits
    (whisper decoder caps at 448)."""
    s = cell.seq_len
    if cfg.max_positions:
        s = min(s, cfg.max_positions)
    return s


def value_and_grad(lm: LM, params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Any]:
    """``(loss, grads)`` of ``lm.loss`` at ``params`` (the reference's
    ``jax.value_and_grad``): the loss detached, the grads a tree of
    ``params``' structure.  A leaf the loss never reads (Whisper's
    encoder ``xattn`` / ``lnx``) gets zeros, as ``jax.grad`` gives it,
    so that clipping, AdamW's decay and checkpoints see every leaf.
    ``params`` are left as they are."""
    leaves = [p.detach().requires_grad_(True) for _, p in _leaves(params)]
    with torch.enable_grad():
        loss = lm.loss(_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(params, grads)


def make_train_step(lm: LM, *, base_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, clip: float = 1.0,
                    weight_decay: float = 0.1, microbatch: int = 0):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss's grads, clipped to global norm ``clip``, one AdamW step on
    the cosine-warmup schedule (params and state updated in place, as
    :func:`~repro_torch.optim.adamw_update` does), and ``metrics``
    ``{"loss", "gnorm", "lr"}`` (0-d tensors and the lr as a float).

    ``microbatch > 1`` accumulates gradients: the batch splits into
    ``microbatch`` sequential chunks whose f32 grads and losses average,
    the reference's ``lax.scan`` accumulation."""
    sched = cosine_warmup_schedule(base_lr, warmup, total)

    def train_step(params, opt_state, batch):
        if microbatch and microbatch > 1:
            loss, grads = None, None
            chunks = {k: torch.chunk(v, microbatch) for k, v in batch.items()}
            for i in range(microbatch):
                loss_i, g_i = value_and_grad(
                    lm, params, {k: c[i] for k, c in chunks.items()})
                if grads is None:
                    loss = loss_i.float()
                    grads = _map(g_i, lambda g: g.float())
                else:
                    loss = loss + loss_i
                    grads = _unflatten(params, [
                        a + b for (_, a), (_, b) in zip(_leaves(grads),
                                                        _leaves(g_i))])
            loss = loss / microbatch
            grads = _map(grads, lambda g: g / microbatch)
        else:
            loss, grads = value_and_grad(lm, params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        params, opt_state = adamw_update(params, grads, opt_state, lr=sched,
                                         weight_decay=weight_decay)
        return params, opt_state, {"loss": loss, "gnorm": gnorm,
                                   "lr": sched(opt_state.step)}
    return train_step


def make_prefill_step(lm: LM):
    def prefill_step(params, batch, cache):
        return lm.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(lm: LM):
    def decode_step(params, batch, cache):
        logits, cache = lm.decode_step(params, batch, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        return tok, logits, cache
    return decode_step
