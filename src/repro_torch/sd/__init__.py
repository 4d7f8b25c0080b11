"""Split-deconvolution plans and their presplit execution."""

from repro_torch.sd.functional import execute
from repro_torch.sd.plan import (BACKENDS, DeconvPlan, plan, resolve_backend,
                                 to_ocmajor)

__all__ = ["BACKENDS", "DeconvPlan", "execute", "plan", "resolve_backend",
           "to_ocmajor"]
