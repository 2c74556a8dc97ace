"""One-JSON-line watchdog for benchmark entry points.

Port of radarml_tpu/utils/watchdog.py. Finding and opening the CUDA
device (driver load, context creation, a first transfer) can hang where
no in-process timeout reaches it. A benchmark entry point that promises
one JSON line keeps that promise through this watchdog: unless the
caller signals readiness in time, it prints an error line and exits
the process hard.
"""

from __future__ import annotations

import json
import os
import threading

__all__ = ["start_json_watchdog"]


def start_json_watchdog(metric: str, timeout_s: float = 900.0, unit: str = "scans/s"):
    """Arm a device-discovery watchdog; returns the 'ready' Event.

    Call ``.set()`` on the returned event after the first successful
    device round trip (e.g. ``apps.common_cli.warm_transfers``). If it is
    not set within `timeout_s`, the watchdog prints one JSON line
    (`metric`, value 0.0, `unit`, vs_baseline 0.0 and an `error` naming
    the CUDA device's discovery) and calls ``os._exit(2)``. Only the
    discovery window is policed: compiling and running after readiness
    may take as long as they take.
    """
    ready = threading.Event()

    def _watch():
        if not ready.wait(timeout=timeout_s):
            print(
                json.dumps(
                    {
                        "metric": metric,
                        "value": 0.0,
                        "unit": unit,
                        "vs_baseline": 0.0,
                        "error": (
                            f"CUDA device discovery did not finish within "
                            f"{timeout_s:g} s (driver load, context creation "
                            f"or the first transfer hung)"
                        ),
                    }
                ),
                flush=True,
            )
            os._exit(2)

    threading.Thread(target=_watch, daemon=True).start()
    return ready
