"""Generative networks of the paper, in PyTorch."""

from repro_torch.models.generative import IMPLS, GenerativeModel, build

__all__ = ["IMPLS", "GenerativeModel", "build"]
