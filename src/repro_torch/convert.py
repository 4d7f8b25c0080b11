"""Carry weights across from the JAX package.

The port keeps the reference's parameter layout (fc ``(in, out)``,
filters ``(*K, Cin, Cout)``, per-output-channel ``b`` and ``scale``), so
converting is a checked copy: every array is validated against the
layer's expected shape and copied to the device unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.accounting import LayerSpec, NetworkSpec
from repro_torch.device import resolve_device


def _expected(layer: LayerSpec) -> Dict[str, tuple]:
    if layer.kind == "fc":
        return {"w": (layer.cin, layer.cout), "b": (layer.cout,)}
    return {"w": (*(layer.k,) * layer.rank, layer.cin, layer.cout),
            "b": (layer.cout,), "scale": (layer.cout,)}


def params_from_numpy(np_params: Mapping[str, Mapping[str, Any]],
                      device, spec: Optional[NetworkSpec] = None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {leaf: array}}`` (numpy or anything ``np.asarray``
    takes, e.g. the JAX package's ``init`` output) -> the same dict of
    tensors on ``device``.  Checks that ``b``/``scale`` match the last
    axis of ``w``, and, given ``spec``, that every layer is present with
    exactly its expected leaves and shapes."""
    dev = resolve_device(device)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    if spec is not None:
        want = {l.name: _expected(l) for l in spec.layers}
        if set(np_params) != set(want):
            raise ValueError(f"layers {sorted(np_params)} do not match "
                             f"spec {spec.name}: {sorted(want)}")
    for name, leaves in np_params.items():
        arrs = {k: np.asarray(v) for k, v in leaves.items()}
        if "w" not in arrs or arrs["w"].ndim < 2:
            raise ValueError(f"layer {name!r} has no weight matrix 'w'")
        for k in ("b", "scale"):
            if k in arrs and arrs[k].shape != (arrs["w"].shape[-1],):
                raise ValueError(f"layer {name!r} {k} shape {arrs[k].shape}"
                                 f" != (w.shape[-1],) of {arrs['w'].shape}")
        if spec is not None:
            shapes = {k: a.shape for k, a in arrs.items()}
            if shapes != want[name]:
                raise ValueError(f"layer {name!r} shapes {shapes} != "
                                 f"expected {want[name]}")
        for k, a in arrs.items():
            if a.dtype.kind != "f":
                raise TypeError(f"layer {name!r} {k} has dtype {a.dtype}; "
                                "expected floating point")
        out[name] = {k: torch.from_numpy(np.array(a, copy=True)).to(dev)
                     for k, a in arrs.items()}
    return out
