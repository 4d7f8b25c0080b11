"""Serving metrics: latency percentiles, goodput, shed rate, occupancy.

One collector instance accompanies one serving run (async scheduler or
the legacy drain loop) and records three event streams:

* **served** — a request completed; carries its latency (completion
  minus *arrival*, so queueing time counts — the user-visible number)
  and whether it met its deadline,
* **shed** — admission control dropped a request (deadline already
  expired, or the estimated service time of its launch could not meet
  it).  Shed requests never enter the latency percentiles; they show up
  in ``shed_rate`` and subtract from goodput instead,
* **launches** — one executed bucket: ``(net, bucket, n, ms)``.  The
  occupancy histogram (how full each launched bucket was) is the
  continuous-batching health signal: a drain loop shows trailing
  1-of-16 buckets, the scheduler should keep buckets near full under
  load.

``summary()`` distils the streams into the ``BENCH_load.json`` record
shape: p50/p95/p99 latency (overall and per net), goodput (on-time
completions per second of trace wall time), shed rate, and the
per-bucket occupancy histogram.  A copy of the JAX package's
``serving/metrics.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

PERCENTILES = (50.0, 95.0, 99.0)


def percentile(values: List[float], q: float) -> Optional[float]:
    """Linear-interpolated percentile (numpy's default method), without
    requiring the inputs pre-sorted.  None on an empty stream — absent
    data must never masquerade as a 0 ms latency."""
    if not values:
        return None
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = math.ceil(pos)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


@dataclass
class ServingMetrics:
    """Event collector for one serving run (see module docstring)."""

    served: List[dict] = field(default_factory=list)
    shed: List[dict] = field(default_factory=list)
    launches: List[dict] = field(default_factory=list)

    # ---- recording -------------------------------------------------------
    def record_served(self, rid: int, net: str, latency_s: float,
                      on_time: bool) -> None:
        self.served.append({"rid": rid, "net": net,
                            "latency_ms": latency_s * 1e3,
                            "on_time": bool(on_time)})

    def record_shed(self, rid: int, net: str, reason: str) -> None:
        self.shed.append({"rid": rid, "net": net, "reason": reason})

    def record_launch(self, net: str, bucket: int, n: int,
                      ms: float) -> None:
        self.launches.append({"net": net, "bucket": int(bucket),
                              "n": int(n), "ms": ms})

    # ---- derived ---------------------------------------------------------
    def _latency_block(self, lats: List[float]) -> dict:
        out = {f"p{int(q) if q == int(q) else q}": (
            round(percentile(lats, q), 3)
            if percentile(lats, q) is not None else None)
            for q in PERCENTILES}
        out["mean"] = (round(sum(lats) / len(lats), 3) if lats else None)
        out["count"] = len(lats)
        return out

    def occupancy_histogram(self) -> Dict[str, Dict[str, int]]:
        """{bucket: {n_real_requests: launch count}} — how full each
        launched bucket actually was (padding rows excluded)."""
        hist: Dict[str, Dict[str, int]] = {}
        for rec in self.launches:
            b = hist.setdefault(str(rec["bucket"]), {})
            b[str(rec["n"])] = b.get(str(rec["n"]), 0) + 1
        return hist

    def summary(self, wall_s: Optional[float] = None) -> dict:
        """The BENCH_load.json record for this run.  ``wall_s`` is the
        trace window (last completion minus first arrival when the
        caller tracks it; falls back to summed launch time, which
        undercounts idle gaps)."""
        lats = [r["latency_ms"] for r in self.served]
        on_time = sum(1 for r in self.served if r["on_time"])
        total = len(self.served) + len(self.shed)
        if wall_s is None:
            wall_s = sum(r["ms"] for r in self.launches) / 1e3
        occupied = sum(r["n"] for r in self.launches)
        padded = sum(r["bucket"] for r in self.launches)
        by_net: Dict[str, List[float]] = {}
        for r in self.served:
            by_net.setdefault(r["net"], []).append(r["latency_ms"])
        shed_reasons: Dict[str, int] = {}
        for r in self.shed:
            shed_reasons[r["reason"]] = shed_reasons.get(r["reason"], 0) + 1
        return {
            "latency_ms": self._latency_block(lats),
            "latency_ms_per_net": {n: self._latency_block(v)
                                   for n, v in sorted(by_net.items())},
            "served": len(self.served),
            "served_on_time": on_time,
            "shed": len(self.shed),
            "shed_reasons": shed_reasons,
            "shed_rate": round(len(self.shed) / total, 4) if total else None,
            "goodput_rps": (round(on_time / wall_s, 3)
                            if wall_s and wall_s > 0 else None),
            "goodput_ratio": (round(on_time / total, 4) if total else None),
            "wall_s": round(wall_s, 4) if wall_s is not None else None,
            "launches": len(self.launches),
            "mean_occupancy": (round(occupied / padded, 4)
                               if padded else None),
            "occupancy_hist": self.occupancy_histogram(),
        }
