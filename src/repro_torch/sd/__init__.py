"""Split-deconvolution plans, the differentiable transposed conv and the
presplit execution."""

from repro_torch.sd.functional import conv_transpose, execute, split_weights
from repro_torch.sd.plan import (BACKENDS, DeconvPlan, plan, resolve_backend,
                                 to_ocmajor)

__all__ = ["BACKENDS", "DeconvPlan", "conv_transpose", "execute", "plan",
           "resolve_backend", "split_weights", "to_ocmajor"]
