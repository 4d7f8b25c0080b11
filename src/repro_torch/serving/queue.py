"""Request model + arrival queue for the async serving scheduler.

A :class:`ServeRequest` carries everything the scheduler needs to make
an admission decision: the target ``net``, an absolute-time ``deadline``
(set from a relative ``deadline_ms`` at submit), and a ``priority``
(lower value = more urgent; ties broken by arrival time, then rid — so
equal-priority traffic stays FIFO and the ordering is total).

The :class:`RequestQueue` separates *pending* requests (submitted with a
future ``arrival_t`` — the open-loop load generator precomputes a whole
Poisson trace up front) from the *live* queue the scheduler batches
from.  ``poll(now)`` moves arrivals across; the scheduler never sees a
request before its arrival time, which is what makes a precomputed
trace behave identically to requests trickling in from a socket.

Everything here is single-threaded by design: the scheduler is an event
loop, and launches (the only slow operation) are synchronous device
calls.  A copy of the JAX package's
``serving/queue.py``.
"""

from __future__ import annotations

import heapq
import itertools
from bisect import insort
from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class ServeRequest:
    """One inference request flowing through the scheduler."""

    rid: int
    net: str
    latent: Any                      # shape == model.input_shape(1)[1:]
    arrival_t: float = 0.0           # absolute seconds (scheduler clock)
    deadline_t: Optional[float] = None   # absolute; None = no deadline
    priority: int = 0                # lower = more urgent

    # Outcome, stamped by the scheduler:
    done_t: Optional[float] = None
    shed_reason: Optional[str] = None

    def order_key(self):
        return (self.priority, self.arrival_t, self.rid)

    @property
    def latency_s(self) -> Optional[float]:
        if self.done_t is None:
            return None
        return self.done_t - self.arrival_t


class RequestQueue:
    """Pending (future-arrival) heap + priority-ordered live queue."""

    def __init__(self) -> None:
        self._pending: List[tuple] = []      # (arrival_t, seq, req) heap
        self._seq = itertools.count()        # heap tiebreak, not identity
        self.live: List[ServeRequest] = []   # sorted by order_key()

    def push(self, req: ServeRequest) -> None:
        heapq.heappush(self._pending, (req.arrival_t, next(self._seq),
                                       req))

    def poll(self, now: float) -> int:
        """Admit every pending request whose arrival time has come.
        Returns how many crossed (0 is the common idle answer)."""
        n = 0
        while self._pending and self._pending[0][0] <= now:
            _, _, req = heapq.heappop(self._pending)
            insort(self.live, req, key=ServeRequest.order_key)
            n += 1
        return n

    def next_arrival(self) -> Optional[float]:
        return self._pending[0][0] if self._pending else None

    def pending_count(self) -> int:
        return len(self._pending)

    def __len__(self) -> int:
        return len(self.live)

    def __bool__(self) -> bool:
        return bool(self.live) or bool(self._pending)
