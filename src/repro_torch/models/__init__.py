"""Generative networks of the paper, in PyTorch."""

from repro_torch.models.generative import (IMPLS, DCGANDiscriminator,
                                          GenerativeModel, build)

__all__ = ["IMPLS", "DCGANDiscriminator", "GenerativeModel", "build"]
