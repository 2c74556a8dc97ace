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

__all__ = ["StageTimer", "RateMeter", "device_trace", "kernel_device_calls", "kernel_device_ms"]


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


#: Profiler traces `kernel_device_ms` took in this process, how many of them
#: came back without the records of a kernel that ran inside them, and, where
#: the caller said how many launches a call makes, the launch records the
#: traces held against the launches their calls made.
TRACES = {"taken": 0, "lacking": 0, "records": 0, "launches": 0}


#: Cycles of the spin kernel (torch.cuda._sleep) that opens and closes a
#: trace's active step (about 30 ms on an H100), and the host's wait before
#: the step closes.
GUARD_CYCLES = 60_000_000
GUARD_S = 0.1


def trace_device_us(fns: dict, symbols: dict, reps: int) -> dict:
    """One torch.profiler (CUPTI) trace of `reps` rounds of the calls in
    `fns`: name -> (total device us, launches) of the kernels whose
    function name contains symbols[name], (0.0, 0) for one the trace
    lacks, both from the trace's kernel events (one a launch).

    Traces lost the records of launches near an edge of their window (on
    an NVIDIA H100 80GB HBM3, 700.00 W): one of each
    of the first two kernels in a 20-round trace at B=4096, and with a
    warm-up step in the schedule still 7 or 8 of 20 of every kernel in
    some traces of short rounds, and the last ~100 ms of a long trace. A
    loss measured in time at the window's edges, not in launches:
    key_averages() and the events agree, so no count is at fault, and a
    warm-up step or a 0.3 ms gap at the start did not end it. So the
    active step, after a warm-up step of one round, opens and closes with
    a spin kernel of GUARD_CYCLES (the calls' records lie that far inside
    the window) and the host waits GUARD_S before closing it; in the chip
    calls since, every trace held every launch record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(GUARD_CYCLES)
        for _ in range(reps):
            for fn in fns.values():
                fn()
        torch.cuda._sleep(GUARD_CYCLES)
        torch.cuda.synchronize()
        time.sleep(GUARD_S)  # the records of the last launches reach the profiler
        prof.step()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {}
    for name, symbol in symbols.items():
        hits = [e for e in kernels if symbol in e.name]
        out[name] = (sum(e.time_range.elapsed_us() for e in hits), len(hits))
    return out


def kernel_device_calls(fns: dict, symbols: dict, reps: int, log=None,
                        launches: Optional[dict] = None) -> dict:
    """Device time of one call of each fn in `fns`, from a torch.profiler
    (CUPTI) trace of `reps` rounds of the calls: name -> (ms a call,
    launches a call) of the kernel whose function name contains
    symbols[name] (a substring of what the trace shows). A call's time is
    its launches' mean time times the launches it makes (launches[name]
    where the caller gives it, else the trace's launch count over `reps`,
    rounded), so it stands beside the call's bound however many launches
    its work plan makes. Needs a CUDA card.

    With `launches`, each trace's records are added to TRACES["records"]
    and the launches its calls made to TRACES["launches"]; a count that is
    not those launches is reported through `log`. A trace that lacks a
    symbol is counted in TRACES, reported and taken again, twice at most;
    a symbol that is still missing raises: no time is ever reported as 0."""
    import torch

    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        got = trace_device_us(fns, symbols, reps)
        TRACES["taken"] += 1
        out = {}
        for name, (us, n) in got.items():
            per_call = launches[name] if launches else round(n / reps)
            if launches:
                TRACES["records"] += n
                TRACES["launches"] += per_call * reps
            if per_call > 0 and us > 0:
                out[name] = (us / n * per_call / 1e3, per_call)
                if n != per_call * reps and log is not None:
                    log(f"{symbols[name]}: {n} launch records for {reps} calls of "
                        f"{per_call} launches")
        missing = [symbols[name] for name in symbols if name not in out]
        if not missing:
            return out
        TRACES["lacking"] += 1
        if log is not None:
            log(f"trace {attempt + 1} shows no device time for {missing}")
    raise RuntimeError(f"the trace shows no device time for kernels {missing}")


def kernel_device_ms(fns: dict, symbols: dict, reps: int, log=None,
                     launches: Optional[dict] = None) -> dict:
    """`kernel_device_calls` without the launch counts: name -> device ms
    of one call of fns[name]."""
    return {name: ms for name, (ms, _)
            in kernel_device_calls(fns, symbols, reps, log, launches).items()}
