"""utils/slopetime.py and utils/watchdog.py of the port against the JAX
package's.

`slope_time` runs here on a scripted clock: `time.perf_counter` is
replaced by a counter that only `call` and `fetch` advance, so the
estimate is a function of the script, not of this host's load (the JAX
package's test_slope_time_cheap_for_slow_programs reads the wall clock
and can fail on a busy host). Both packages' estimators run on the same
script and must return the same value after the same number of calls.
The watchdog runs in a subprocess.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from radarml_tpu.utils import slopetime as jslope
from radarml_tpu_torch.utils import slopetime as tslope

REPO = Path(__file__).resolve().parents[1]


class Script:
    """A clock that moves `call_s` per call and `fetch_s(i)` at the i-th
    fetch; counts both."""

    def __init__(self, call_s, fetch_s=lambda i: 0.0):
        self.now, self.calls, self.fetches = 0.0, 0, 0
        self.call_s, self.fetch_s = call_s, fetch_s

    def clock(self):
        return self.now

    def call(self):
        self.calls += 1
        self.now += self.call_s
        return self.calls

    def fetch(self, out):
        self.now += self.fetch_s(self.fetches)
        self.fetches += 1


def _both(monkeypatch, make, **kw):
    out = []
    for mod in (tslope, jslope):
        s = make()
        monkeypatch.setattr(mod.time, "perf_counter", s.clock)
        out.append((mod.slope_time(s.call, s.fetch, **kw), s.calls, s.fetches))
    return out


def test_cheap_for_slow_programs(monkeypatch):
    """One 10 ms call dominates the signal window at once: no escalation,
    3 pairs at K 2 / 12, 42 calls, and the exact per-call time."""
    (t, calls, _), jax_run = _both(monkeypatch, lambda: Script(0.01))
    assert (t, calls) == jax_run[:2]
    assert t == pytest.approx(0.01, rel=1e-9)
    assert calls == 42


def test_positive_under_phase_drift(monkeypatch):
    """A 40 ms episode on the first fetch (the K_lo run of the first
    pair) would make a naive two-point slope negative."""
    run, jax_run = _both(monkeypatch, lambda: Script(0.001, lambda i: 0.04 if i == 0 else 0.0))
    assert run == jax_run
    assert 0.0005 < run[0] < 0.002


def test_escalates_for_fast_programs(monkeypatch):
    """A 0.1 ms call: K_hi grows ×4 until the window holds 50 ms of
    signal or reaches the cap (12 → 48 → 192 → 256)."""
    run, jax_run = _both(monkeypatch, lambda: Script(1e-4))
    assert run == jax_run
    assert run[0] == pytest.approx(1e-4, rel=1e-9)
    # four escalating pairs, then two more at K_hi = 256
    assert run[1] == sum(2 + k for k in (12, 48, 192, 256)) + 2 * (2 + 256)


def test_retry_then_best_positive_pair(monkeypatch):
    """Fetch costs that fall faster than the calls add: every pair's slope
    is negative until the retry at the cap, where the last resort is the
    smallest positive pair or the magnitude, never a negative time."""
    def fetch_s(i):
        return 1.0 / (1 + i)  # the K_lo run of each pair pays more

    for kw in ({}, {"max_k": 12}):
        run, jax_run = _both(monkeypatch, lambda: Script(1e-5, fetch_s), **kw)
        assert run == jax_run
        assert run[0] > 0


WATCHDOG = r"""
import sys, time
from radarml_tpu_torch.utils.watchdog import start_json_watchdog
ready = start_json_watchdog("scans_per_s", timeout_s=float(sys.argv[1]))
if sys.argv[2] == "set":
    ready.set()
time.sleep(float(sys.argv[3]))
print("finished")
"""


@pytest.mark.parametrize("mode", ["fires", "set"])
def test_watchdog(mode):
    args = ["0.3", "hang", "30"] if mode == "fires" else ["0.3", "set", "0.8"]
    done = subprocess.run([sys.executable, "-c", WATCHDOG, *args], cwd=REPO,
                          env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=60)
    lines = done.stdout.strip().splitlines()
    if mode == "set":  # silent once readiness is signalled
        assert done.returncode == 0 and lines == ["finished"]
        return
    assert done.returncode == 2 and len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "error"}
    assert (rec["metric"], rec["value"], rec["vs_baseline"]) == ("scans_per_s", 0.0, 0.0)
    assert "CUDA device" in rec["error"] and "TPU" not in rec["error"]
