"""Zero-downtime model hot-reload for the serving loop.

The reference's only model-update path is: stop predict.py, retrain,
restart it with the new pickle (predict.py:224-227). Here a background
watcher polls the model artifact's mtime; when it changes, the new
model is loaded and warmed OFF the serving path, then swapped in with
one atomic attribute assignment — in-flight batches finish on the old
program, the next batch runs the new one. Pairs with online learning
(`train --online_learn` rewrites the same artifact) for a
capture → retrain → serve loop with no serving restart.

Load/compile failures keep the old model serving and are logged —
a bad artifact must never take the service down.

Copy of radarml_tpu/serving/reload.py (it has no JAX in it).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Optional

logger = logging.getLogger(__name__)

__all__ = ["ModelReloader"]


class ModelReloader(threading.Thread):
    """Watch `path`; on mtime change call build() then on_swap(new).

    `build` must return a ready-to-serve predictor (do the warm-up
    inside it); `on_swap` performs the atomic swap. Exceptions from
    either are logged and the previous model keeps serving.
    """

    def __init__(
        self,
        path: str,
        build: Callable[[], object],
        on_swap: Callable[[object], None],
        poll_s: float = 2.0,
    ):
        super().__init__(daemon=True, name="model-reloader")
        self._path = path
        self._build = build
        self._on_swap = on_swap
        self._poll_s = poll_s
        self._halt = threading.Event()
        self._mtime = self._stat()
        self._failed_mtime: Optional[float] = None  # last mtime whose build failed
        self._retry_wait = poll_s  # failure backoff, doubles to 60 s
        self.reloads = 0
        self.failures = 0

    def _stat(self) -> Optional[float]:
        try:
            return os.stat(self._path).st_mtime
        except OSError:
            return None

    def run(self):
        while not self._halt.wait(self._poll_s):
            mtime = self._stat()
            if mtime is None or mtime == self._mtime:
                continue
            # Writers may still be mid-write; wait for mtime to settle
            # one poll interval before loading.
            settle = mtime
            while not self._halt.wait(self._poll_s):
                nxt = self._stat()
                if nxt == settle:
                    break
                settle = nxt
            if self._halt.is_set():
                return
            # A build of THIS same artifact already failed: retry on a
            # capped exponential backoff instead of every poll — build()
            # loads and warms a model on the card, and a deterministically
            # bad artifact must not spin it (transient races still retry).
            if (
                self._failed_mtime == settle
                and self._halt.wait(self._retry_wait)
            ):
                return
            try:
                new = self._build()
                self._on_swap(new)
                # Commit the watched mtime only on success: a build
                # that raced a non-atomic writer (or hit a transient
                # failure) retries on the next poll instead of leaving
                # the completed artifact unserved forever.
                self._mtime = settle
                self._failed_mtime = None
                self._retry_wait = self._poll_s
                self.reloads += 1
                logger.info(
                    "hot-reloaded model from %s (reload #%d)",
                    self._path, self.reloads,
                )
            except Exception:
                self.failures += 1
                if self._failed_mtime != settle:
                    self._failed_mtime = settle
                    self._retry_wait = self._poll_s
                    logger.exception(
                        "model reload from %s failed; keeping previous "
                        "model (will retry while the file is unchanged)",
                        self._path,
                    )
                else:
                    logger.debug(
                        "model reload retry from %s failed again",
                        self._path,
                    )
                self._retry_wait = min(self._retry_wait * 2, 60.0)

    def stop(self):
        self._halt.set()
