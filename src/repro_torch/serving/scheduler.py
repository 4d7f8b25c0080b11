"""Continuous-batching scheduler: the async serving loop.

The legacy loop (``GenServer.serve``) drains synchronous request
groups: it partitions whatever is queued into per-net groups and runs
them all to completion before looking at the queue again, so a request
arriving just after a drain starts waits for *every* group ahead of it.
This module replaces that with an event loop that re-forms a batch at
**every launch boundary**:

* :meth:`ContinuousScheduler.step` polls arrivals, sheds requests whose
  deadline has already passed or provably cannot be met (admission
  control against the service-time estimate), picks the next batch with
  the starvation-bounded ``take_group`` policy (a cold net's lone
  request no longer blocks a hot net's full bucket — but is served
  within ``max_skips`` launches), pads it to the pow2 bucket, and
  launches.  New arrivals are eligible for the very next launch.
* Service times are estimated per ``(net, bucket)``: seeded from the
  engine's measured per-layer entries
  (:meth:`repro_torch.engine.SDEngine.estimate_ms`, ``None`` until tiles
  are measured), then tracked as an EWMA of observed launch
  wall times, so the estimate converges on the true cost of the
  machine it is running on.
* :meth:`swap_checkpoint` queues a new parameter set for a net; the
  swap is applied at the next launch boundary, so any single launch
  serves entirely-old or entirely-new weights, never a mix.  Rebinding
  reuses every cell: params and bound plans are *arguments* of a
  cell, so the swap triggers **zero** cell rebuilds — enforced: every
  launch into an already-built ``(net, bucket, dtype)`` cell asserts
  the server's ``compile_count`` (cells built) did not move.

The scheduler drives any server exposing the small surface
``GenServer`` has (``bucket``/``max_batch``/``run_group``/``model``/
``swap_checkpoint`` + the compile-cache introspection attributes);
tests substitute a stub server and a :class:`VirtualClock` to get
deterministic deadline behaviour.  A copy of the JAX package's
``serving/scheduler.py`` that synchronises with torch.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.launch.batching import take_group
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.queue import RequestQueue, ServeRequest

# Admission slack: a request is shed as unmeetable only when the
# estimate says it would finish this fraction *past* its deadline —
# estimates are noisy, and shedding a request that would have made it
# is strictly worse than serving one slightly late.
ADMIT_SLACK = 0.1


class WallClock:
    """Real time: monotonic now(), blocking sleep()."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class VirtualClock:
    """Deterministic test clock: sleep() advances instantly; launch
    stubs advance() it by their pretended service time."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.advance(dt)

    def advance(self, dt: float) -> None:
        if dt > 0:
            self.t += dt


class ServiceEstimator:
    """Per-(net, bucket) service-time estimate in milliseconds.

    ``seed_fn(net, bucket) -> ms | None`` supplies the cold-start value
    (the engine's summed measured per-layer plan entries); every
    observed launch then folds into an EWMA.  ``estimate_ms`` returns
    None when nothing is known — admission control admits optimistically
    in that case rather than shedding on a guess.
    """

    def __init__(self, seed_fn: Optional[Callable[[str, int],
                                                  Optional[float]]] = None,
                 alpha: float = 0.4):
        self._seed_fn = seed_fn
        self._alpha = float(alpha)
        self._ewma: Dict[tuple, float] = {}
        self._seed_cache: Dict[tuple, Optional[float]] = {}

    def estimate_ms(self, net: str, bucket: int) -> Optional[float]:
        key = (net, bucket)
        if key in self._ewma:
            return self._ewma[key]
        if key not in self._seed_cache:
            seed = self._seed_fn(net, bucket) if self._seed_fn else None
            self._seed_cache[key] = seed
        return self._seed_cache[key]

    def observe(self, net: str, bucket: int, ms: float) -> None:
        key = (net, bucket)
        prev = self._ewma.get(key)
        self._ewma[key] = (ms if prev is None
                           else self._alpha * ms
                           + (1 - self._alpha) * prev)


class ContinuousScheduler:
    """Event loop over a bucketed generative server (see module doc)."""

    def __init__(self, server, clock=None, max_skips: int = 4,
                 collect_outputs: bool = True,
                 launch_fn: Optional[Callable[..., Any]] = None,
                 estimator: Optional[ServiceEstimator] = None):
        self.server = server
        self.clock = clock or WallClock()
        self.max_skips = int(max_skips)
        self.collect_outputs = collect_outputs
        self._launch_fn = launch_fn
        self.queue = RequestQueue()
        self.metrics = ServingMetrics()
        self.results: Dict[int, Any] = {}
        self.estimator = estimator or ServiceEstimator(
            seed_fn=self._engine_seed)
        self._skip_counts: Dict[str, int] = {}
        self._pending_swaps: Dict[str, Any] = {}
        self._finished: set = set()      # rids served or shed
        self._submitted: set = set()
        self.swaps_applied = 0

    # ---- submission ------------------------------------------------------
    def submit(self, net: str, latent, rid: Optional[int] = None,
               arrival_t: Optional[float] = None,
               deadline_ms: Optional[float] = None,
               priority: int = 0) -> ServeRequest:
        """Enqueue one request.  ``arrival_t`` in the scheduler clock's
        timebase (defaults to now — i.e. already arrived); a relative
        ``deadline_ms`` is anchored to the arrival time."""
        if arrival_t is None:
            arrival_t = self.clock.now()
        if rid is None:
            rid = len(self._submitted)
        deadline_t = (arrival_t + deadline_ms / 1e3
                      if deadline_ms is not None else None)
        req = ServeRequest(rid=rid, net=net, latent=latent,
                           arrival_t=arrival_t, deadline_t=deadline_t,
                           priority=priority)
        return self.submit_request(req)

    def submit_request(self, req: ServeRequest) -> ServeRequest:
        if req.rid in self._submitted:
            raise ValueError(f"duplicate rid {req.rid}")
        self._submitted.add(req.rid)
        self.queue.push(req)
        return req

    # ---- hot swap --------------------------------------------------------
    def swap_checkpoint(self, net: str, params) -> None:
        """Queue a checkpoint swap for ``net``, applied at the next
        launch boundary (so no launch ever mixes weight sets).  The
        rebind reuses every already-compiled executable — the zero-
        recompile invariant is asserted on each subsequent launch."""
        self._pending_swaps[net] = params

    def _apply_swaps(self) -> None:
        for net, params in self._pending_swaps.items():
            self.server.swap_checkpoint(net, params)
            self.swaps_applied += 1
        self._pending_swaps.clear()

    # ---- service-time model ---------------------------------------------
    def _engine_seed(self, net: str, bucket: int) -> Optional[float]:
        # Prefer the server's own estimate (GenServer.estimate_ms keys
        # the lookup on what one device launches under its mesh — the
        # per-device batch and shard degree — so admission control on a
        # --dp/--mp server is not seeded wrong by the parallelism
        # factor); fall back to the engine for bare-engine servers.
        est_fn = getattr(self.server, "estimate_ms", None)
        if est_fn is not None:
            return est_fn(net, bucket)
        model_fn = getattr(self.server, "model", None)
        if model_fn is None:
            return None
        model, _ = model_fn(net)
        engine = getattr(model, "engine", None)
        if engine is None:
            return None
        return engine.estimate_ms(bucket)

    # ---- shedding --------------------------------------------------------
    def _shed(self, req: ServeRequest, reason: str) -> None:
        if req.rid in self._finished:
            raise RuntimeError(f"request {req.rid} already finished")
        self._finished.add(req.rid)
        req.shed_reason = reason
        self.metrics.record_shed(req.rid, req.net, reason)

    # ---- the loop --------------------------------------------------------
    def step(self) -> bool:
        """One scheduling decision: launch a batch, shed, or sleep to
        the next arrival.  Returns False when fully drained."""
        now = self.clock.now()
        self.queue.poll(now)
        self._apply_swaps()          # launch boundary: safe swap point

        # Shed requests whose deadline has already passed — they can
        # never be goodput, and padding a bucket with them steals
        # capacity from requests that still can be.
        live: List[ServeRequest] = []
        for req in self.queue.live:
            if req.deadline_t is not None and now > req.deadline_t:
                self._shed(req, "expired")
            else:
                live.append(req)
        self.queue.live = live

        if not self.queue.live:
            nxt = self.queue.next_arrival()
            if nxt is None:
                return False                       # drained
            self.clock.sleep(max(0.0, nxt - now))
            self.queue.poll(self.clock.now())
            return True

        group, rest = take_group(self.queue.live,
                                 lambda r: r.net,
                                 self.server.max_batch,
                                 skip_counts=self._skip_counts,
                                 max_skips=self.max_skips)
        self.queue.live = rest
        net = group[0].net

        # Admission control: against the estimated service time of the
        # bucket this group would launch, shed members whose deadline
        # can no longer be met (the launch itself would push them past
        # it) — they'd consume bucket rows to produce late output.
        est = self.estimator.estimate_ms(net,
                                         self.server.bucket(len(group)))
        keep = group
        if est is not None:
            keep = []
            for req in group:
                if (req.deadline_t is not None
                        and now + est / 1e3
                        > req.deadline_t + ADMIT_SLACK * est / 1e3):
                    self._shed(req, "unmeetable")
                else:
                    keep.append(req)
        if not keep:
            return True
        self._launch_group(net, keep)
        return True

    def run(self) -> Dict[int, Any]:
        """Drive step() until every submitted request is served or
        shed; returns the collected outputs ({} when
        ``collect_outputs=False``)."""
        while self.step():
            pass
        missing = self._submitted - self._finished
        if missing:
            raise RuntimeError(
                f"scheduler drained with {len(missing)} request(s) "
                f"unaccounted for: {sorted(missing)[:8]}")
        return self.results

    # ---- launching -------------------------------------------------------
    def _launch_group(self, net: str, reqs: List[ServeRequest]) -> None:
        bucket = self.server.bucket(len(reqs))
        cells = getattr(self.server, "_compiled", None)
        # The server owns its cell-key format (GenServer.cell_key adds
        # the mesh shape under --dp/--mp); building the key here with a
        # different format would silently disable the zero-recompile
        # assertion below.
        key_fn = getattr(self.server, "cell_key", None)
        if key_fn is not None:
            key = key_fn(net, bucket)
        else:
            key = (net, bucket, getattr(self.server, "dtype_name", ""))
        fresh = cells is None or key not in cells
        count0 = getattr(self.server, "compile_count", None)

        t0 = self.clock.now()
        if self._launch_fn is not None:
            out = self._launch_fn(net, [r.latent for r in reqs], bucket)
        else:
            out = self.server.run_group(net, [r.latent for r in reqs])
            if isinstance(out, torch.Tensor) and out.is_cuda:
                torch.cuda.synchronize(out.device)
        done = self.clock.now()

        if (not fresh and count0 is not None
                and self.server.compile_count != count0):
            raise RuntimeError(
                f"compiled cell {key} retraced mid-serving "
                f"(compile_count {count0} -> "
                f"{self.server.compile_count}); the bucket-shape set "
                "must stay closed and checkpoint swaps must reuse "
                "executables")

        self.estimator.observe(net, bucket, (done - t0) * 1e3)
        self.metrics.record_launch(net, bucket, len(reqs),
                                   (done - t0) * 1e3)
        for i, req in enumerate(reqs):
            if req.rid in self._finished:
                raise RuntimeError(
                    f"request {req.rid} double-served")
            self._finished.add(req.rid)
            req.done_t = done
            on_time = (req.deadline_t is None or done <= req.deadline_t)
            self.metrics.record_served(req.rid, req.net,
                                       done - req.arrival_t, on_time)
            if self.collect_outputs and out is not None:
                self.results[req.rid] = out[i]

    # ---- reporting -------------------------------------------------------
    def stats(self, wall_s: Optional[float] = None) -> dict:
        rec = self.metrics.summary(wall_s=wall_s)
        rec["swaps_applied"] = self.swaps_applied
        rec["compiles"] = getattr(self.server, "compile_count", None)
        cells = getattr(self.server, "_compiled", None)
        if cells is not None:
            rec["compile_cache"] = sorted(str(k) for k in cells)
        return rec
