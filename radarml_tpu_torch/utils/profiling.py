"""Per-stage timing for the scan pipelines.

Port of radarml_tpu/utils/profiling.py: lightweight per-stage wall
timers around the capture/predict loops and throughput counters with
EMA rates. Both are host-side only. `device_trace` is a torch.profiler
scope that writes a Chrome trace, and `kernel_device_ms` reads the device
time of named CUDA kernels from a torch.profiler trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

logger = logging.getLogger(__name__)

__all__ = ["StageTimer", "RateMeter", "device_trace", "kernel_device_ms"]


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


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler scope over the CPU and, where a card is present,
    CUDA activity; writes a Chrome trace (`trace-<pid>.json`) into
    `log_dir`. Does nothing when log_dir is empty."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)


#: Profiler traces `kernel_device_ms` took in this process, and how many of
#: them came back without the records of a kernel that ran inside them.
TRACES = {"taken": 0, "lacking": 0}


def trace_device_us(fns: dict, symbols: dict, reps: int) -> dict:
    """One torch.profiler (CUPTI) trace of `reps` rounds of the calls in
    `fns`: name -> (total device us, launches) of the kernels whose
    function name contains symbols[name], (0.0, 0) for one the trace
    lacks."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for fn in fns.values():
                fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for name, symbol in symbols.items():
        hits = [e for e in events if symbol in e.key]
        out[name] = (sum(getattr(e, "device_time_total", 0.0) for e in hits),
                     sum(e.count for e in hits))
    return out


def kernel_device_ms(fns: dict, symbols: dict, reps: int, log=None) -> dict:
    """Mean device time of one launch of each kernel, from a torch.profiler
    (CUPTI) trace of `reps` rounds of the calls in `fns`: name -> ms, for
    every name -> kernel function name (a substring of what the trace
    shows) in `symbols`. Needs a CUDA card.

    A trace now and then came back without a kernel's records in earlier
    runs (cause not established; `utils/kernel_probe.py traces` looks for
    it), so a trace that lacks a symbol is counted in TRACES, reported
    through `log` and taken again, twice at most; a symbol that is still
    missing raises: no time is ever reported as 0."""
    import torch

    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        got = trace_device_us(fns, symbols, reps)
        TRACES["taken"] += 1
        out = {name: us / n / 1e3 for name, (us, n) in got.items() if n > 0 and us > 0}
        missing = [symbols[name] for name in symbols if name not in out]
        if not missing:
            return out
        TRACES["lacking"] += 1
        if log is not None:
            log(f"trace {attempt + 1} shows no device time for {missing}")
    raise RuntimeError(f"the trace shows no device time for kernels {missing}")
