"""Generative networks of the paper, in PyTorch; the dense LM of the
scaffolding is in :mod:`repro_torch.models.lm`."""

from repro_torch.models.generative import (IMPLS, DCGANDiscriminator,
                                          GenerativeModel, build)

__all__ = ["IMPLS", "DCGANDiscriminator", "GenerativeModel", "build"]
