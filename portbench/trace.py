"""The device trace of a traced window (torch.profiler, CUPTI) and what
the readers take from it.

CUPTI traces lost the records of launches near the edges of their window
on an H100; so the active window opens and closes with a spin kernel
(torch.cuda._sleep) that keeps the measured launches well inside it, and
the host waits before closing it (the technique of the program's
profiling utilities). The device window runs from the end of the opening
spin to the start of the closing one; nothing inside it is lost, so a
gap in it is a gap on the device and not a lost record.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Callable, List, Tuple

#: Cycles of each guard spin (about 30 ms on an H100) and the host's wait
#: before the window closes.
GUARD_CYCLES = 60_000_000
GUARD_S = 0.1
GUARD_SYMBOL = "spin_kernel"
HOST_MARK = "portbench."


@dataclasses.dataclass
class Trace:
    """Device operations (name, start us, end us) inside the device window,
    the window's bounds in us, and, for labelling gaps, the host's marked
    spans and the operators directly under them, each (start, end, name)
    in order: neither list's spans overlap."""

    ops: List[Tuple[str, float, float]]
    start_us: float
    end_us: float
    marks: List[Tuple[float, float, str]] = dataclasses.field(default_factory=list)
    host_ops: List[Tuple[float, float, str]] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def kernels(self) -> List[Tuple[str, float, float]]:
        """The kernels alone: no copies or fills."""
        return [o for o in self.ops if not o[0].startswith(("Memcpy", "Memset"))]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        out = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """Intervals of the window in which nothing ran on the device."""
        out, t = [], self.start_us
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end_us > t:
            out.append((t, self.end_us))
        return out

    def host_label(self, t: float) -> str:
        """What the host was doing at `t`: the marked span and the
        operator under it, or "other"."""

        def at(spans):
            i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
            return spans[i][2] if i >= 0 and spans[i][1] >= t else None

        mark, op = at(self.marks), at(self.host_ops)
        label = mark[len(HOST_MARK):] if mark else "other"
        return f"{label}:{op}" if mark and op else label

    def breakdown(self, top: int = 10, width: int = 160) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, in seconds."""
        by_op = collections.Counter()
        for name, s, e in self.ops:
            by_op[name[:width]] += (e - s) / 1e6
        by_host = collections.Counter()
        for s, e in self.gaps():
            by_host[self.host_label(s)[:width]] += (e - s) / 1e6
        return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
                "idle_gaps": [[n, v] for n, v in by_host.most_common(top)]}


def traced(work: Callable, warm: Callable):
    """Run `warm()` as the profiler's warm-up step and `work(mark)` in its
    active step between two guard spins: (work's result, Trace). `mark`
    is a context manager that names a host span in the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(GUARD_CYCLES)
        result = work(record_function)
        torch.cuda._sleep(GUARD_CYCLES)
        torch.cuda.synchronize()
        time.sleep(GUARD_S)  # the last launches' records reach the profiler
        prof.step()
    device, marks, host_ops = [], [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith((HOST_MARK, "ProfilerStep")):  # annotations, not work
                device.append((e.name, start, end))
        elif e.name.startswith(HOST_MARK):
            marks.append((start, end, e.name))
        elif e.cpu_parent is not None and e.cpu_parent.name.startswith(HOST_MARK):
            host_ops.append((start, end, e.name))
    return result, from_ops(device, sorted(marks), sorted(host_ops))


def from_ops(device: List[Tuple[str, float, float]], marks=(), host_ops=()) -> Trace:
    """The Trace of the device operations between the first and the last
    guard spin."""
    guards = sorted((o for o in device if GUARD_SYMBOL in o[0]), key=lambda o: o[1])
    if len(guards) < 2:
        raise RuntimeError(f"the trace holds {len(guards)} guard spins, not 2: "
                           "it lost records at its edges")
    start, end = guards[0][2], guards[-1][1]
    ops = [o for o in device if GUARD_SYMBOL not in o[0] and o[1] >= start and o[2] <= end]
    return Trace(ops=ops, start_us=start, end_us=end, marks=list(marks),
                 host_ops=list(host_ops))

