"""AdamW, its schedule and gradient clipping, over trees of tensors.

The formulas and defaults of the reference's ``repro.optim.adamw`` (b2 =
0.95, weight decay 0.1 applied to the master copy, bias-corrected
moments, ``lr`` a number or a schedule of the step).  A tree is nested
dicts and lists of tensors (the generators' ``{layer: {name: w}}``, the
LM's tree with its ``slots`` list).  Unlike the reference, which returns
new arrays, :func:`adamw_update` writes the new values into the params
and the state in place under ``torch.no_grad()``: that keeps each
parameter tensor (and any autograd leaf flag on it) alive across steps.
An in-place update bumps each tensor's ``_version``, which is how the SD
engine knows to split its filters again (``SDEngine.bound_to``).  A
checkpoint therefore snapshots the tree before it returns
(:mod:`repro_torch.checkpoint`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

Tree = Any
Path = Tuple[Union[str, int], ...]


def _leaves(tree: Tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """``(path, leaf)`` of every leaf of nested dicts (in key order) and
    lists (in index order): the reference's ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _at(tree: Tree, path: Path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _unflatten(tree: Tree, leaves) -> Tree:
    """``leaves`` (in :func:`_leaves`' order) in ``tree``'s structure."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)
    return walk(tree)


def _map(tree: Tree, fn) -> Tree:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


@dataclass
class OptState:
    step: int
    mu: Tree
    nu: Tree
    master: Optional[Tree]   # f32 master copy when params are low-precision


def adamw_init(params: Tree, *, master_dtype: torch.dtype = torch.float32,
               state_dtype: torch.dtype = torch.float32) -> OptState:
    """Zero moments in ``state_dtype``, and a master copy in
    ``master_dtype`` when a param is not in that dtype."""
    mu = _map(params, lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                            device=p.device))
    nu = _map(params, lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                            device=p.device))
    needs_master = any(p.dtype != master_dtype for _, p in _leaves(params))
    master = (_map(params, lambda p: p.detach().to(master_dtype, copy=True))
              if needs_master else None)
    return OptState(0, mu, nu, master)


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: OptState, *,
                 lr: Union[float, Callable[[int], float]], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Tree, OptState]:
    """One AdamW step, in place; returns ``(params, state)``.  ``lr`` may
    be a number or a schedule called with the new step count."""
    state.step += 1
    lr_t = float(lr(state.step)) if callable(lr) else lr
    # Bias corrections in f32, as the reference computes them.
    b1t = float(np.float32(1) - np.float32(b1) ** np.float32(state.step))
    b2t = float(np.float32(1) - np.float32(b2) ** np.float32(state.step))
    for path, p in _leaves(params):
        m, v = _at(state.mu, path), _at(state.nu, path)
        gf = _at(grads, path).to(m.dtype)
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        pm = _at(state.master, path) if state.master is not None else None
        base = pm if pm is not None else p.to(m.dtype)
        nm = base - lr_t * ((m / b1t) / (torch.sqrt(v / b2t) + eps)
                            + weight_decay * base)
        if pm is not None:
            pm.copy_(nm)
        p.copy_(nm.to(p.dtype))
    return params, state


def global_norm(grads: Tree, *, mesh=None, specs: Tree = None
                ) -> torch.Tensor:
    """``sqrt(sum of every leaf's sum of squares)`` in f32, the leaves
    added in tree order as the reference's Python ``sum``.  With a live
    ``mesh`` and the grads' ``specs`` (a rank's blocks), each leaf's sum
    is taken over the mesh axes its spec splits it over, so a leaf
    replicated over an axis is counted once: two collectives of one
    number per leaf."""
    sq = [torch.sum(torch.square(g.float())) for _, g in _leaves(grads)]
    if mesh is not None:
        v = torch.stack(sq)
        for axis in mesh.axis_names:
            split = [any(e == axis or (isinstance(e, tuple) and axis in e)
                         for e in _at(specs, path))
                     for path, _ in _leaves(grads)]
            if mesh.axis_size(axis) > 1 and any(split):
                mask = torch.tensor(split, device=v.device)
                v = torch.where(mask, mesh.all_reduce(v, axis), v)
        sq = list(v.unbind())
    total = None
    for x in sq:
        total = x if total is None else total + x
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float, *, mesh=None,
                        specs: Tree = None) -> Tuple[Tree, torch.Tensor]:
    """``(grads * min(1, max_norm / max(norm, 1e-9)), norm)``, each leaf
    scaled in f32 and cast back; the norm a 0-d f32 tensor on the
    grads' device (no host sync).  ``mesh``/``specs``: a rank's blocks,
    the norm over the whole mesh (:func:`global_norm`)."""
    gn = global_norm(grads, mesh=mesh, specs=specs)
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    return _map(grads, lambda g: (g.float() * scale).to(g.dtype)), gn


def cosine_warmup_schedule(base_lr: float, warmup: int, total: int,
                           min_frac: float = 0.1) -> Callable[[int], float]:
    """``lr(step)``: linear warmup to ``base_lr`` over ``warmup`` steps,
    then a cosine down to ``min_frac * base_lr`` at ``total``.  The
    reference's f32 arithmetic, step by step, in numpy f32; returns a
    Python float."""
    f32 = np.float32
    lr0, w = f32(base_lr), f32(warmup)
    span = f32(max(warmup, 1))
    decay = f32(max(total - warmup, 1))
    lo, amp = f32(min_frac), f32((1 - min_frac) * 0.5)

    def lr(step) -> float:
        s = f32(int(step))
        if s < w:
            return float(lr0 * s / span)
        prog = np.clip((s - w) / decay, f32(0), f32(1)).astype(f32)
        return float(lr0 * (lo + amp * (f32(1) + np.cos(f32(math.pi) * prog))))
    return lr
