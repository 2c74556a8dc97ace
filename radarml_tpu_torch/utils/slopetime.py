"""Slope timing: seconds per call from the difference of two run lengths.

Port of radarml_tpu/utils/slopetime.py. A loop of K dispatches followed
by one forced completion costs K·t + c, where c is the per-measurement
host cost: the launch queue filling and draining, the synchronise or the
device→host read that ends the run, the timer itself. On the card, a
PyTorch call returns before the device finishes, so a loop without a
forced completion measures the enqueue; and c is not small beside a
short kernel. So every rate is a SLOPE: run K_lo and K_hi calls, each
run ending in `fetch` (a synchronise, or `.item()` of a small slice),
and divide the time difference by (K_hi − K_lo); c cancels.

Two rules keep the estimator sound when c drifts between runs (a busy
host, a neighbour on a shared card, a clock change):

1. ADAPTIVE K_hi: while the measured (t_hi − t_lo) is below
   `min_signal_s`, K_hi grows ×4 (capped at `max_k`) until the work
   between the two points dominates the jitter. A slow call never
   escalates, so a probe of an expensive mode stays cheap.
2. PAIRED slopes: each rep measures (K_lo, K_hi) back to back and takes
   the pair's own slope; the median over pairs absorbs an episode that
   lands between pairs. A non-positive median triggers one escalated
   retry, and the last resort is the smallest positive pair, never a
   negative time.

For a kernel's device time, CUDA events around many launches
(utils/profiling.py) stay the tool; slopes time whole calls, host work
included.
"""

from __future__ import annotations

import time
from typing import Callable

__all__ = ["slope_time"]


def _run(call, fetch, k: int) -> float:
    t0 = time.perf_counter()
    out = None
    for _ in range(k):
        out = call()
    fetch(out)
    return time.perf_counter() - t0


def slope_time(
    call: Callable[[], object],
    fetch: Callable[[object], object],
    k_lo: int = 2,
    k_hi: int = 12,
    reps: int = 3,
    min_signal_s: float = 0.05,
    max_k: int = 256,
) -> float:
    """Seconds per `call()` via paired two-point slopes with forced
    completion.

    `call` dispatches the work under test and returns its output; `fetch`
    forces completion (e.g. ``lambda out: torch.cuda.synchronize()`` or
    ``lambda out: out[:1].item()``). Returns the median of `reps` paired
    slopes, escalating K_hi until the timed signal exceeds `min_signal_s`
    (see the module docstring).
    """
    pairs = []

    def measure_pair(k):
        t_lo = _run(call, fetch, k_lo)
        t_hi = _run(call, fetch, k)
        return (t_hi - t_lo) / (k - k_lo), t_lo, t_hi

    while True:
        s, t_lo, t_hi = measure_pair(k_hi)
        if t_hi - t_lo >= min_signal_s or k_hi >= max_k:
            break
        k_hi = min(max_k, k_hi * 4)
    pairs.append(s)
    for _ in range(reps - 1):
        pairs.append(measure_pair(k_hi)[0])

    pairs.sort()
    med = pairs[len(pairs) // 2]
    if med > 0:
        return med
    # A drift episode straddled the pairs: retry once with a larger
    # signal window before falling back to the best positive pair.
    if k_hi < max_k:
        return slope_time(call, fetch, k_lo=k_lo, k_hi=min(max_k, k_hi * 4),
                          reps=reps, min_signal_s=min_signal_s, max_k=max_k)
    positive = [p for p in pairs if p > 0]
    if positive:
        return positive[0]
    # every pair non-positive at max_k: the magnitude, never a negative time
    return abs(med) or 1e-12
