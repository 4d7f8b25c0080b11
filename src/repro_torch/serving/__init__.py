"""Async serving: continuous batching, deadlines, checkpoint hot swap.

A copy of the JAX package's ``serving`` subsystem, importing only the
port: :class:`ContinuousScheduler` re-forms a pow2-bucket batch at every
launch boundary, sheds requests whose deadline cannot be met, and
applies checkpoint swaps between launches; :class:`ServingMetrics`
reports latency percentiles, goodput and bucket occupancy.
"""

from repro_torch.serving.metrics import PERCENTILES, ServingMetrics, percentile
from repro_torch.serving.queue import RequestQueue, ServeRequest
from repro_torch.serving.scheduler import (ADMIT_SLACK, ContinuousScheduler,
                                           ServiceEstimator, VirtualClock,
                                           WallClock)

__all__ = [
    "ADMIT_SLACK", "PERCENTILES", "ContinuousScheduler", "RequestQueue",
    "ServeRequest", "ServiceEstimator", "ServingMetrics", "VirtualClock",
    "WallClock", "percentile",
]
