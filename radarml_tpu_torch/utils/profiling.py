"""Per-stage timing for the scan pipelines.

Port of radarml_tpu/utils/profiling.py: lightweight per-stage wall
timers around the capture/predict loops and throughput counters with
EMA rates. Both are host-side only. `kernel_device_ms` reads the device
time of named CUDA kernels from a torch.profiler trace. The JAX package's
`device_trace` (a jax.profiler scope) is not ported yet; its counterpart
here will be a torch.profiler/NVTX scope.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

logger = logging.getLogger(__name__)

__all__ = ["StageTimer", "RateMeter", "kernel_device_ms"]


@dataclasses.dataclass
class _Stat:
    count: int = 0
    total: float = 0.0
    best: float = float("inf")
    worst: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.best = min(self.best, dt)
        self.worst = max(self.worst, dt)


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name.

    Usage:
        timer = StageTimer()
        with timer("trigger"):
            radar.trigger()
        with timer("classify"):
            predictor(...)
        timer.log_summary()
    """

    def __init__(self):
        self._stats: Dict[str, _Stat] = defaultdict(_Stat)

    @contextlib.contextmanager
    def __call__(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stats[stage].add(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, s in self._stats.items():
            if not s.count:
                continue
            out[name] = {
                "count": s.count,
                "total_s": s.total,
                "mean_ms": 1e3 * s.total / s.count,
                "min_ms": 1e3 * s.best,
                "max_ms": 1e3 * s.worst,
            }
        return out

    def log_summary(self, level: int = logging.INFO):
        for name, row in sorted(
            self.summary().items(), key=lambda kv: -kv[1]["total_s"]
        ):
            logger.log(
                level,
                "stage %-16s n=%-6d mean=%8.3fms min=%8.3fms max=%8.3fms",
                name, row["count"], row["mean_ms"], row["min_ms"],
                row["max_ms"],
            )

    def reset(self):
        self._stats.clear()


class RateMeter:
    """Exponential-moving-average event rate (scans/s, samples/s)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self._last: Optional[float] = None
        self.rate: float = 0.0
        self.count: int = 0

    def tick(self, n: int = 1) -> float:
        now = time.perf_counter()
        self.count += n
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                inst = n / dt
                self.rate = (
                    inst
                    if self.rate == 0.0
                    else (1 - self.alpha) * self.rate + self.alpha * inst
                )
        self._last = now
        return self.rate


def kernel_device_ms(fns: dict, symbols: dict, reps: int, log=None) -> dict:
    """Mean device time of one launch of each kernel, from a torch.profiler
    (CUPTI) trace of `reps` rounds of the calls in `fns`: name -> ms, for
    every name -> kernel function name (a substring of what the trace
    shows) in `symbols`. Needs a CUDA card.

    A trace now and then comes back without a kernel's records (cause not
    established), so a trace that lacks a symbol is reported through `log`
    and taken again, twice at most; a symbol that is still missing raises:
    no time is ever reported as 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for fn in fns.values():
                    fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        out, missing = {}, []
        for name, symbol in symbols.items():
            hits = [e for e in events if symbol in e.key]
            us = sum(getattr(e, "device_time_total", 0.0) for e in hits)
            n = sum(e.count for e in hits)
            if n > 0 and us > 0:
                out[name] = us / n / 1e3
            else:
                missing.append(symbol)
        if not missing:
            return out
        if log is not None:
            log(f"trace {attempt + 1} shows no device time for {missing}")
    raise RuntimeError(f"the trace shows no device time for kernels {missing}")
