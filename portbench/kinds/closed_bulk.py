"""Closed bulk loop: recorded scans that already sit on the card, scored
batch after batch, with at most `in_flight` batches queued.

Users: bulk re-scoring of recorded scans, for example after a model
swap. The pool holds `pool_batches` distinct batches of uint8 scans made
on the card from the seed (the form the stream holds scans in until the
predictor's call). Each step hands the predictor the next pool batch
without synchronising, copies its classes and probabilities into pinned
host buffers and records an event; once `in_flight` steps are queued the
host waits for the oldest. A step counts for the rate once its outputs
are on the host inside the window.

For the comparison the host keeps a copy of the outputs of a sample of
the steps drawn from the seed: each pool batch's first step in the
window, every step still queued when the window closes, and each other
step with probability JUDGE_SHARE.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from portbench import scenes
from portbench.reference.arena import Arena

#: The share of the window's other steps whose outputs are judged.
JUDGE_SHARE = 0.125


@dataclasses.dataclass
class Batch:
    cubes: torch.Tensor  # (B, X, Y, Z) uint8
    xyz: torch.Tensor  # (B, T, 3) float32 cm
    valid: torch.Tensor  # (B, T) bool
    n_valid: int
    voxels: int  # voxels the valid targets' planes cover

    @property
    def scans(self) -> int:
        return self.cubes.shape[0]


@dataclasses.dataclass
class Step:
    index: int
    batch: int
    slot: int
    dispatch_s: float  # host seconds in the predictor's call
    event: object = None
    done_s: Optional[float] = None  # host clock when its outputs were seen on the host


@dataclasses.dataclass
class Window:
    steps: List[Step]
    kept: list  # (batch index, pred (B, T), proba (B, T, C)) host copies
    start: float
    end: float

    def counted(self) -> List[Step]:
        """Steps whose outputs reached the host inside the window."""
        return [s for s in self.steps if s.done_s is not None and s.done_s <= self.end]


def pool(traffic: dict, seed: int, device) -> List[Batch]:
    """The traffic's distinct batches, drawn from `seed` on `device`."""
    arena = Arena.from_dict(traffic["scan_arena"])
    gen = scenes.generator(seed, device)
    out = []
    for _ in range(int(traffic["pool_batches"])):
        cubes, xyz, valid, _ = scenes.scan_batch(
            gen, int(traffic["batch"]), int(traffic["slots"]), traffic["scene_classes"], arena,
            float(traffic["noise_level"]))
        voxels = scenes.plane_voxels(torch.stack(arena.indices(xyz), -1), valid, arena)
        out.append(Batch(cubes, xyz, valid, int(valid.sum()), voxels))
    return out


class _HostDone:
    """Stands in for a CUDA event where the work ran on the host."""

    def record(self):
        pass

    def query(self):
        return True

    def synchronize(self):
        pass


class Loop:
    """The closed loop of `program` over `batches` on `device`."""

    def __init__(self, program: Callable, batches: List[Batch], traffic: dict, device):
        self.program = program
        self.batches = batches
        self.depth = int(traffic["in_flight"])
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.slots = None

    def _event(self):
        return torch.cuda.Event() if self.cuda else _HostDone()

    def _dispatch(self, b: int, slot: int, mark) -> Step:
        batch = self.batches[b]
        with mark("portbench.dispatch"):
            t0 = time.perf_counter()
            pred, _, proba = self.program(batch.cubes, batch.xyz, batch.valid)
            t1 = time.perf_counter()
        with mark("portbench.copy"):
            if self.slots is None:
                self.slots = [tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=self.cuda)
                                    for o in (pred, proba)) for _ in range(self.depth)]
            host_pred, host_proba = self.slots[slot]
            host_pred.copy_(pred, non_blocking=True)
            host_proba.copy_(proba, non_blocking=True)
            event = self._event()
            event.record()
        return Step(index=-1, batch=b, slot=slot, dispatch_s=t1 - t0, event=event)

    def warm(self, rounds: int = 1) -> None:
        """Each pool batch through the whole step, `rounds` times."""
        for _ in range(rounds):
            for b in range(len(self.batches)):
                self._dispatch(b, 0, _no_mark).event.synchronize()

    def run(self, seconds: float, rng: np.random.Generator, mark=None) -> Window:
        mark = mark or _no_mark
        steps, kept = [], []
        free = list(range(self.depth))
        queued = collections.deque()
        seen = set()
        start = time.perf_counter()
        end = start + seconds

        def retire(step: Step):
            with mark("portbench.wait"):
                step.event.synchronize()
            step.done_s = time.perf_counter()
            keep = step.batch not in seen or step.done_s > end or rng.random() < JUDGE_SHARE
            if keep:
                with mark("portbench.keep"):
                    seen.add(step.batch)
                    kept.append((step.batch, *(t.numpy().copy() for t in self.slots[step.slot])))
            free.append(step.slot)

        while True:
            while queued and (not free or queued[0].event.query()):
                retire(queued.popleft())
            if time.perf_counter() >= end:
                break
            step = self._dispatch(len(steps) % len(self.batches), free.pop(), mark)
            step.index = len(steps)
            steps.append(step)
            queued.append(step)
        while queued:
            retire(queued.popleft())
        return Window(steps=steps, kept=kept, start=start, end=end)


@contextlib.contextmanager
def _no_mark(name):
    yield
