"""Device time of a call on the card, with the host's time per call
hidden.

:func:`ahead_ms` is the timer behind the measured tiles
(:func:`repro_torch.kernels.autotune.measure`), ``chip_smoke.py``'s
"ahead" readings and ``gemm_sweep.py``.  A deconv launch of the port at
serving sizes takes more host time per call than device time (PERF.md
§6), so events around back-to-back calls read the host, not the
kernel.
"""

from __future__ import annotations

AHEAD_CYCLES = 4_000_000  # torch.cuda._sleep before a timed run of calls


def ahead_ms(fn, calls: int = 20) -> float:
    """Device ms per call of ``fn``: CUDA events around ``calls`` calls
    queued behind ``torch.cuda._sleep``, so the card starts them only
    once the host has queued them all and the host's time per call
    (the wrapper's Python, a ctypes launch) is hidden.  The sleep is
    lengthened (four times, at most) until the start event is still
    pending when the last call is queued; a call that waits on the card
    itself (a copy from pageable host memory) never lets the host get
    ahead, and its last reading, host gaps included, is returned."""
    import torch
    for _ in range(3):
        fn()
    cycles = AHEAD_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            break
        cycles *= 4
    return start.elapsed_time(end) / calls
