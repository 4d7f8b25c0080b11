"""Step functions of LM training and serving, and the abstract input
specs of every (arch x shape) cell.

The port of the JAX package's ``launch/steps.py``.  ``input_specs``,
``abstract_params``, ``abstract_opt_state`` and ``abstract_cache`` build
on the ``meta`` device (shapes and dtypes, no memory: the torch form of
``jax.eval_shape``), so the full 132B / 398B trees get their specs
(:mod:`repro_torch.distributed.sharding`) without a byte behind them.
PyTorch runs eagerly, so a step is the plain callable the reference
would ``jax.jit``.  Every LM that ``build_lm`` builds runs through them:
attention decoders, dense or MoE, xLSTM, Jamba, and with their
embeddings in the batch (``patch_embeds``, ``frame_embeds``) InternVL2
and Whisper.

A step made under a :func:`~repro_torch.distributed.sharding.
mesh_context` keeps that context and installs it around every call (the
reference jits its steps under ``mesh_context`` with the shardings of
:func:`~repro_torch.distributed.sharding.param_specs`); on a live mesh
every LM runs sharded (:mod:`repro_torch.models.lm`).
There a step takes the rank's blocks of the params, the optimizer state
and the cache and the whole batch, and the train step sums the data
ranks' gradients of each param the data axis does not split, clips by
the norm over the whole mesh (a replicated leaf counted once) and runs
AdamW on the rank's blocks in place.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed import sharding as SH
from repro_torch.models.lm import LM, build_lm
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_warmup_schedule)
from repro_torch.optim.adamw import _at, _leaves, _map, _unflatten


def effective_seq(cfg: ArchConfig, cell: ShapeCell) -> int:
    """Clamp the cell's sequence length to the arch's positional limits
    (whisper decoder caps at 448)."""
    s = cell.seq_len
    if cfg.max_positions:
        s = min(s, cfg.max_positions)
    return s


def input_specs(cfg: ArchConfig, cell: ShapeCell,
                batch_override: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Meta tensors for the step's ``batch`` argument (the reference's
    ``ShapeDtypeStruct`` tree): int32 ``inputs`` (and ``targets`` to
    train) of the cell's batch and its text length, plus f32
    ``patch_embeds`` / ``frame_embeds`` where the config reads them; one
    new token to decode."""
    b = batch_override or cell.global_batch
    s = effective_seq(cfg, cell)

    def spec(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    if cell.step == "decode":
        return {"inputs": spec((b, 1))}
    text = s - (cfg.n_patches if cfg.frontend == "patch" else 0)
    out = {"inputs": spec((b, text))}
    if cell.step == "train":
        out["targets"] = spec((b, text))
    if cfg.frontend == "patch":
        out["patch_embeds"] = spec((b, cfg.n_patches, cfg.frontend_dim),
                                   torch.float32)
    if cfg.enc_dec:
        out["frame_embeds"] = spec((b, cfg.enc_positions, cfg.d_model),
                                   torch.float32)
    return out


def abstract_params(cfg: ArchConfig):
    """``(lm, params)``: the LM on the meta device and its param tree
    drawn there by ``lm.init`` (shapes and dtypes only)."""
    lm = build_lm(cfg, device="meta")
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        return lm, lm.init(gen)


def abstract_opt_state(params_shapes, state_dtype: str = "float32"):
    """AdamW's state of a meta param tree: f32 master, moments in
    ``state_dtype``."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[state_dtype]
    return adamw_init(params_shapes, master_dtype=torch.float32,
                      state_dtype=dt)


def abstract_cache(lm: LM, cfg: ArchConfig, cell: ShapeCell):
    """The cache of a cell's batch and sequence on ``lm``'s device (the
    meta device for :func:`abstract_params`' LM)."""
    return lm.init_cache(cell.global_batch, effective_seq(cfg, cell))


def _installed(mc: Optional[SH.MeshContext]):
    """``mc`` installed, or the caller's context left as it is."""
    return (contextlib.nullcontext() if mc is None
            else SH.mesh_context(mc))


def _splits(spec, axis: str) -> bool:
    return any(e == axis or (isinstance(e, tuple) and axis in e)
               for e in spec)


def value_and_grad(lm: LM, params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Any]:
    """``(loss, grads)`` of ``lm.loss`` at ``params`` (the reference's
    ``jax.value_and_grad``): the loss detached, the grads a tree of
    ``params``' structure.  A leaf the loss never reads (Whisper's
    encoder ``xattn`` / ``lnx``) gets zeros, as ``jax.grad`` gives it,
    so that clipping, AdamW's decay and checkpoints see every leaf.
    ``params`` are left as they are.  On a live mesh ``params`` are the
    rank's blocks and ``batch`` the whole batch: over each batch axis
    (``'data'``, and ``'pod'`` on a two-pod mesh) the grads of the
    leaves it does not split are summed here (those the data axis
    splits were summed by their gather's adjoint), so each rank holds
    its block of the batch mean's gradient."""
    leaves = [p.detach().requires_grad_(True) for _, p in _leaves(params)]
    with torch.enable_grad():
        loss = lm.loss(_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    mc = SH.current()
    mesh = SH.live_mesh(mc)
    axes = [] if mesh is None else [a for a in mc.batch_axes
                                    if mesh.axis_size(a) > 1]
    if axes:
        specs = SH.param_specs(params, mc)
        for axis in axes:
            grads = [g if _splits(_at(specs, path), axis)
                     else mesh.all_reduce(g, axis)
                     for (path, _), g in zip(_leaves(params), grads)]
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
    the reference's ``lax.scan`` accumulation (on a mesh the whole
    batch splits, as the reference's reshape does, and each chunk's
    rows then split over the data axis).

    Made under a mesh context, the step runs in it (module doc)."""
    sched = cosine_warmup_schedule(base_lr, warmup, total)
    mc = SH.current()

    def train_step(params, opt_state, batch):
        with _installed(mc):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
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
        mesh = SH.live_mesh()
        grads, gnorm = clip_by_global_norm(
            grads, clip, mesh=mesh,
            specs=None if mesh is None else SH.param_specs(params,
                                                           SH.current()))
        params, opt_state = adamw_update(params, grads, opt_state, lr=sched,
                                         weight_decay=weight_decay)
        return params, opt_state, {"loss": loss, "gnorm": gnorm,
                                   "lr": sched(opt_state.step)}
    return train_step


def greedy(logits: torch.Tensor, batch: int) -> torch.Tensor:
    """Greedy tokens (B, S) int32 of ``logits`` (B, S, V) of a batch of
    ``batch`` rows.  On a live mesh, ``logits`` is the rank's block: the
    ranks' vocab blocks are searched as one (the lowest index among
    equal maxima, as one argmax over the whole vocabulary), and the
    tokens are gathered over the batch axes where they split the batch,
    so every rank returns the whole batch's."""
    mc = SH.current()
    mesh = SH.live_mesh(mc)
    if mesh is None:
        return torch.argmax(logits, -1).to(torch.int32)
    n = logits.shape[-1]
    idx = torch.argmax(logits, -1, keepdim=True)
    val = logits.gather(-1, idx).float()
    # vocab indices are exact in f32 (below 2^24): one gather for both
    both = mesh.all_gather(torch.stack(
        [val, (idx + mesh.model_index * n).float()], -1), "model", -2)
    best = torch.argmax(both[..., 0], -1, keepdim=True)
    tok = both[..., 1].gather(-1, best)[..., 0]
    tok = SH.gather_block(tok, SH.constrain((batch,), "batch", mc=mc), mesh)
    return tok.to(torch.int32)


def make_prefill_step(lm: LM):
    """``(params, batch, cache) -> (last-token logits, cache)``; made
    under a mesh context, it runs in it (the rank's block of the
    logits)."""
    mc = SH.current()

    def prefill_step(params, batch, cache):
        with _installed(mc):
            return lm.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(lm: LM):
    """``(params, batch, cache) -> (tokens, logits, cache)``: the greedy
    tokens of the whole batch (:func:`greedy`) beside the logits (the
    rank's block on a mesh)."""
    mc = SH.current()

    def decode_step(params, batch, cache):
        with _installed(mc):
            logits, cache = lm.decode_step(params, batch, cache)
            tok = greedy(logits, batch["inputs"].shape[0])
        return tok, logits, cache
    return decode_step
