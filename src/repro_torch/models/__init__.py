"""Generative networks of the paper, in PyTorch; the dense LM of the
scaffolding is in :mod:`repro_torch.models.lm`."""

from repro_torch.models.generative import (DCGANDiscriminator,
                                          GenerativeModel, build)

__all__ = ["DCGANDiscriminator", "GenerativeModel", "build"]
