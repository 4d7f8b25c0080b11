"""AdamW over nested dicts of tensors, updating in place.

The formulas and defaults of the reference's ``repro.optim.adamw`` (b2 =
0.95, weight decay 0.1 applied to the master copy, bias-corrected
moments).  Unlike the reference, which returns new arrays,
:func:`adamw_update` writes the new values into the params and the state
in place under ``torch.no_grad()``: that keeps each parameter tensor
(and any autograd leaf flag on it) alive across steps.  An in-place
update bumps each tensor's ``_version``, which is how the SD engine
knows to split its filters again (``SDEngine.bound_to``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def _leaves(tree: Tree, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """``(path, tensor)`` of every tensor of a nested dict, in key
    order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree: Tree, path: Tuple[str, ...]) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


def _map(tree: Tree, fn) -> Tree:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@dataclass
class OptState:
    step: int
    mu: Tree
    nu: Tree
    master: Optional[Tree]   # f32 master copy when params are low-precision


def adamw_init(params: Tree) -> OptState:
    """Zero f32 moments, and an f32 master copy when a param is not
    f32."""
    mu = _map(params, lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device))
    nu = _map(params, lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device))
    needs_master = any(p.dtype != torch.float32 for _, p in _leaves(params))
    master = (_map(params, lambda p: p.detach().float().clone())
              if needs_master else None)
    return OptState(0, mu, nu, master)


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: OptState, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Tree, OptState]:
    """One AdamW step, in place; returns ``(params, state)``."""
    state.step += 1
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
        nm = base - lr * ((m / b1t) / (torch.sqrt(v / b2t) + eps)
                          + weight_decay * base)
        if pm is not None:
            pm.copy_(nm)
        p.copy_(nm.to(p.dtype))
    return params, state
