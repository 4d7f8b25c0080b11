"""Request bucketing for the generative server (a copy of the JAX
package's ``launch/batching.py`` helpers the port needs).

The server groups requests by net and pads each group to a power-of-two
batch *bucket*, so the set of launch shapes it ever runs is small and
closed: one serving cell per ``(net, bucket, dtype)``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, TypeVar

T = TypeVar("T")


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"pow2_floor needs n >= 1, got {n}")
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


def pow2_bucket(n: int, max_bucket: int | None = None) -> int:
    """Smallest power of two >= n, capped at ``pow2_floor(max_bucket)``.

    The compile-cache key for a padded batch: every request count maps
    to one of log2(max) shapes, so a serving process compiles each
    (arch, bucket, dtype) cell at most once.  The cap is clamped DOWN
    to a power of two before use — a non-pow2 ``max_bucket`` used to be
    returned verbatim for large ``n``, leaking one extra non-pow2 shape
    into the compile cache (and breaking the closed-set invariant the
    servers rely on).  Callers must therefore cap their *group* sizes
    at ``pow2_floor(max_bucket)`` too (see ``serve_gen.GenServer``).
    """
    if n < 1:
        raise ValueError(f"bucket size for n={n}")
    b = 1
    while b < n:
        b *= 2
    if max_bucket is not None:
        b = min(b, pow2_floor(max_bucket))
    return b


def take_group(queue: List[T], key_fn: Callable[[T], object],
               max_group: int,
               skip_counts: Optional[Dict[object, int]] = None,
               max_skips: int = 0) -> Tuple[List[T], List[T]]:
    """Pop the next compatible group from a FIFO queue.

    Takes the queue head, then up to ``max_group - 1`` further items
    with the *same key* (preserving order), leaving everything else
    queued.

    **Starvation-bounded full-bucket preference** (``max_skips > 0``,
    ``skip_counts`` a caller-held ``{key: times bypassed}`` dict): a
    head whose group cannot fill its bucket no longer blocks a
    *different* key that already has a full bucket waiting — the full
    bucket launches first and the head's bypass count is incremented.
    The bound is hard: once a key has been bypassed ``max_skips``
    times, its group goes next regardless of what else is queued (the
    count resets when it is served), so every take either serves the
    current head or spends one of its finitely many bypasses.  With the
    default ``max_skips=0`` the legacy strict head-of-line behaviour is
    unchanged — the group is always built around the oldest waiting
    item.
    """
    if not queue:
        return [], []
    head_key = key_fn(queue[0])
    take_key = head_key
    if max_skips > 0 and skip_counts is not None \
            and skip_counts.get(head_key, 0) < max_skips:
        counts: Dict[object, int] = {}
        for item in queue:
            k = key_fn(item)
            counts[k] = counts.get(k, 0) + 1
        if counts[head_key] < max_group:
            # first key, in order of its oldest waiting item, with a
            # full bucket ready (the head's own key was just ruled out)
            for item in queue:
                k = key_fn(item)
                if k != head_key and counts[k] >= max_group:
                    take_key = k
                    skip_counts[head_key] = \
                        skip_counts.get(head_key, 0) + 1
                    break
    if skip_counts is not None and take_key == head_key:
        skip_counts.pop(head_key, None)          # served: bound resets
    group: List[T] = []
    rest: List[T] = []
    for item in queue:
        if len(group) < max_group and key_fn(item) == take_key:
            group.append(item)
        else:
            rest.append(item)
    return group, rest
