"""Checkpointing for fault tolerance: the reference's
``repro.checkpoint.manager``, in its on-disk format.

* **Format** — ``step_%010d.tmp/`` is written and then renamed to
  ``step_%010d/``: ``arrays.npz`` (one array per flattened key),
  ``manifest.json`` (``step``, ``time``, ``keys``, ``shapes``, numpy
  ``dtypes`` such as ``"float32"``, ``"bfloat16"``, ``"int32"``) and
  ``commit``, written last.  Keys are the reference's: dict keys sorted
  and joined by ``/``, list items by index, a dataclass's or
  NamedTuple's fields in order, a ``None`` leaf as ``<key>#none`` (in
  the manifest only).  bf16 is stored widened to f32 and cast back on
  restore.  A Python int leaf (``OptState.step``) is stored as a 0-d
  int32 array, as the reference's ``OptState.step`` is, and restored as
  a Python int.  Each package therefore restores the other's files.
* **Snapshot** — the port's AdamW updates params in place, so
  :meth:`CheckpointManager.save` copies every tensor to host memory on
  the caller's thread (``.detach().to("cpu", copy=True)``, then a
  synchronise of the card) before it returns; the writer thread only
  serialises those copies and can never see a later step's values.
* **Async** — the npz, manifest and commit are written on a background
  thread; a failed write is raised at the next :meth:`~CheckpointManager.
  wait` (or ``save``, which waits for the previous one first).
* **Restart discovery** — :func:`restore_latest` picks the newest
  committed step, or returns ``(0, None)``.
* **Retention** — the last ``keep`` checkpoints stay.
* **Sharded trees** ("elastic restore") — ``save(..., mesh=)`` gathers a
  tree whose leaves are this rank's blocks under a spec tree (the form
  :func:`~repro_torch.distributed.gen_param_specs` gives) over ``mesh``,
  so the file holds whole arrays, and only the mesh's rank 0 writes.
  ``restore(..., shardings=)`` takes ``(mesh, spec_tree)``: each leaf
  whose spec tree entry is a spec is placed as
  :func:`~repro_torch.launch.train_gen.place_params` places it (this
  rank's block, on ``mesh.device``), so a tree saved on one mesh
  restores onto another.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import Mesh, gather_block, local_block

# numpy dtype names of the manifest <-> torch dtypes
_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
          "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NUMPY = {v: k for k, v in _TORCH.items()}


def _fields(tree) -> Optional[Tuple[str, ...]]:
    """Field names of a NamedTuple or dataclass instance, else None."""
    if hasattr(tree, "_fields"):
        return tuple(tree._fields)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return tuple(f.name for f in dataclasses.fields(tree))
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    names = _fields(tree)
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif names is not None:
        for k in names:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix[:-1] + "#none"] = None
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat: Dict[str, Any], prefix: str = ""):
    names = _fields(template)
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if names is not None:
        return type(template)(**{
            k: _unflatten_into(getattr(template, k), flat, f"{prefix}{k}/")
            for k in names})
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    if template is None:
        return None
    return flat[prefix[:-1]]


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _spec_flat(specs, prefix: str = "") -> Dict[str, tuple]:
    """A spec tree flattened by :func:`_flatten`'s keys (a spec is a
    tuple leaf, not a list of leaves)."""
    if isinstance(specs, dict):
        out: Dict[str, tuple] = {}
        for k in sorted(specs):
            out.update(_spec_flat(specs[k], f"{prefix}{k}/"))
        return out
    if _is_spec(specs):
        return {prefix[:-1]: specs}
    if isinstance(specs, (list, tuple)):
        out = {}
        for i, v in enumerate(specs):
            out.update(_spec_flat(v, f"{prefix}{i}/"))
        return out
    return {}


def _to_host(v) -> Any:
    """A host snapshot of a leaf: a CPU tensor, a 0-d int32 array for a
    Python int, a numpy copy of anything else, or None."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    if isinstance(v, int):
        return np.asarray(v, np.int32)
    return np.array(v, copy=True)


def _storable(v) -> Tuple[np.ndarray, str]:
    """(array npz can hold, the manifest's numpy dtype name)."""
    if isinstance(v, torch.Tensor):
        name = _NUMPY[v.dtype]
        if v.dtype == torch.bfloat16:
            return v.float().numpy(), name
        return v.numpy(), name
    a = np.asarray(v)
    name = str(a.dtype)
    if a.dtype.kind == "V" or "bfloat16" in name:
        return a.astype(np.float32), "bfloat16"
    return a, name


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False, *,
             mesh: Optional[Mesh] = None, specs: Any = None) -> None:
        """Snapshot ``tree`` at ``step``.  Non-blocking by default: the
        host copy is taken before this returns, the files are written on
        a background thread.  With ``mesh`` and ``specs`` (a spec tree
        over ``tree``'s sharded leaves), each such leaf is gathered over
        the mesh first, every rank must call this, and only rank 0
        writes."""
        self.wait()                        # one in-flight save at a time
        flat = _flatten(tree)
        if mesh is not None and specs is not None:
            sflat = _spec_flat(specs)
            flat = {k: (gather_block(v, sflat[k], mesh)
                        if isinstance(v, torch.Tensor) and k in sflat else v)
                    for k, v in flat.items()}
        # device -> host snapshot NOW (values must not see later updates)
        host = {k: _to_host(v) for k, v in flat.items()}
        if any(isinstance(v, torch.Tensor) and v.is_cuda
               for v in flat.values()):
            torch.cuda.synchronize()
        if mesh is not None and mesh.rank != 0:
            return

        def _write():
            try:
                tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
                fin = os.path.join(self.dir, f"step_{step:010d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                arrays = {k: _storable(v) for k, v in host.items()
                          if v is not None}
                np.savez(os.path.join(tmp, "arrays.npz"),
                         **{k: a for k, (a, _) in arrays.items()})
                manifest = {
                    "step": step,
                    "time": time.time(),
                    "keys": sorted(host.keys()),
                    "shapes": {k: list(a.shape)
                               for k, (a, _) in arrays.items()},
                    "dtypes": {k: name for k, (_, name) in arrays.items()},
                }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                with open(os.path.join(tmp, "commit"), "w") as f:
                    f.write("ok")
                if os.path.exists(fin):
                    shutil.rmtree(fin)
                os.rename(tmp, fin)
                self._gc()
            except BaseException as e:     # surfaced on next wait()
                self._last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    # ------------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "commit")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[int, Any]:
        """Load a checkpoint into the structure of ``template``.

        Each tensor leaf comes back in the template leaf's dtype, on its
        device; an int leaf as a Python int.  ``shardings``: optional
        ``(mesh, spec_tree)``, the spec tree over (part of) ``template``
        as :func:`~repro_torch.distributed.gen_param_specs` gives one
        (``{"g": specs}`` for a ``{"g", "d"}`` tree); a leaf with a
        spec comes back as this rank's block on ``mesh.device``, the
        template holding the whole leaf.  The reference takes a tree of
        ``NamedSharding`` there."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        step = step if step is not None else steps[-1]
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        mesh, sflat = None, {}
        if shardings is not None:
            mesh, specs = shardings
            sflat = _spec_flat(specs)
        flat = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for k, tmpl in _flatten(template).items():
                if k.endswith("#none"):
                    continue
                arr = data[k]
                if isinstance(tmpl, int):
                    flat[k] = int(arr)
                    continue
                saved = _TORCH.get(manifest["dtypes"].get(k), None)
                t = torch.from_numpy(np.array(arr, copy=True))
                if saved is not None and t.dtype != saved:
                    t = t.to(saved)        # bf16 widened in the file
                t = t.to(tmpl.dtype)
                if k in sflat:
                    flat[k] = local_block(t, sflat[k], mesh).to(mesh.device)
                else:
                    flat[k] = t.to(tmpl.device)
        return step, _unflatten_into(template, flat)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)


def restore_latest(directory: str, template: Any, shardings: Any = None):
    """Restart discovery: (step, tree) of the newest valid checkpoint,
    or (0, None) when starting fresh."""
    try:
        mgr = CheckpointManager(directory)
        return mgr.restore(template, shardings=shardings)
    except FileNotFoundError:
        return 0, None
