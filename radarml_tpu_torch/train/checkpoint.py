"""Checkpoint/resume for the neural families, with `torch.save`.

Port of radarml_tpu/train/checkpoint.py, which keeps versioned orbax
step checkpoints with retention. Here a checkpoint is one file per step,
`step_<n>.pt` in the store's directory, holding the tree (state dicts,
tensors and plain containers) and a `meta` dict. Files are written to a
temporary name and renamed, so a crash never leaves half a checkpoint
under a step's name. They load with `weights_only=True`: tensors and
plain containers only.

NamedTuples are stored as dicts of their fields, numpy arrays as
tensors and numpy scalars as Python numbers; `restore(template=...)`
re-imposes the template's container types, as the JAX store does for
orbax's dicts. Orbax checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["CheckpointStore"]

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _plain(tree: Any) -> Any:
    """NamedTuples as dicts, numpy arrays as CPU tensors, tensors detached
    onto the CPU; other containers kept."""
    if hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, np.generic):
        return tree.item()
    return tree


def _rebuild(template: Any, raw: Any) -> Any:
    """Re-impose the template's container types onto a restored tree."""
    if hasattr(template, "_fields") and isinstance(raw, dict):
        return type(template)(**{f: _rebuild(getattr(template, f), raw[f])
                                 for f in template._fields})
    if isinstance(template, dict) and isinstance(raw, dict):
        return {k: _rebuild(template[k], raw[k]) if k in template else raw[k]
                for k in raw}
    if isinstance(template, (list, tuple)) and isinstance(raw, (list, tuple)):
        return type(template)(_rebuild(t, r) for t, r in zip(template, raw))
    return raw


class CheckpointStore:
    """Step-indexed checkpoint directory with retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._keep = max(int(max_to_keep), 1)
        os.makedirs(self._dir, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self._dir)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{int(step)}.pt")

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None):
        tmp = self._path(step) + ".tmp"
        torch.save({"tree": _plain(tree), "meta": dict(meta or {})}, tmp)
        os.replace(tmp, self._path(step))
        for old in self._steps()[:-self._keep]:
            os.remove(self._path(old))
        logger.info("checkpoint step %d saved to %s", step, self._dir)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(
        self, step: Optional[int] = None, template: Any = None
    ) -> Tuple[int, Any, Dict]:
        """(step, tree, meta), tensors on the CPU; raises FileNotFoundError
        when the store is empty or `step` is not kept. Pass `template` (a
        tree with the target structure) to get NamedTuples back."""
        if step is None:
            step = self.latest_step()
        if step is None or not os.path.exists(self._path(step)):
            raise FileNotFoundError(f"no checkpoint of step {step} in {self._dir}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        tree = payload["tree"]
        if template is not None:
            tree = _rebuild(template, tree)
        return int(step), tree, dict(payload["meta"])

    def close(self):
        """Nothing is held open between calls; kept for the JAX store's API."""
