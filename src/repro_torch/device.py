"""Device selection: the card by default, the CPU only on request.

Nothing in the port falls back to the CPU quietly.  An entry point that
was given no device runs on ``cuda`` and raises when no card is found;
the CPU is used only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The first CUDA device; raises when none is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' (or --device cpu) "
            "to run the port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None, *,
                   shapes_only: bool = False) -> torch.device:
    """``None`` -> :func:`default_device`; ``"cpu"`` -> the CPU; a CUDA
    device is checked to exist.  ``"meta"`` (tensors with shapes and
    dtypes but no memory, the torch form of ``jax.eval_shape``) only for
    a build that computes nothing, ``shapes_only=True``; every path that
    runs refuses it."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "meta":
        if not shapes_only:
            raise ValueError("the meta device holds shapes only; this path "
                             "runs, so pass cuda or cpu")
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is "
                           "not available")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def describe_device(device: DeviceLike = None) -> str:
    """One line naming the device every printed number was taken on:
    for a card, ``nvidia-smi``'s ``name, power.limit``; for the CPU,
    ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index}"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(dev)}, power limit not readable"
