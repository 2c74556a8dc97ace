"""How `correct` is decided: the answers the timed path delivered to the
host, judged one by one against the reference's answers to the same
inputs.

Each number is worked out for every cell; a cell compares those that
its limits/<workload>.json names, each against its limit:

* proba_gap: the widest gap, over the judged valid targets and their
  classes, between a delivered probability and the reference's;
* proba_gap_p999: the 99.9th percentile of the targets' gaps (a target's
  gap: its widest over the classes), steady from seed to seed where a few
  targets' gaps swing by the nature of the math;
* wrong_answers: judged slots whose class is wrong: an empty slot not
  UNKNOWN, a probability that is not finite, or a valid target whose
  class differs from the reference's where the reference's top two lie
  more than twice the file's `tie_margin` apart and its best more than
  `tie_margin` from the min_proba threshold. An exact count: limit 0.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

UNKNOWN = -1


def _clear(ref_proba, min_proba: float, margin: float):
    """Per slot of one batch: whether the reference's class is clear, its
    top two more than twice `margin` apart and its best more than
    `margin` from the threshold."""
    top = np.sort(np.nan_to_num(ref_proba, nan=0.0), -1)
    best, second = top[..., -1], top[..., -2]
    return (best - second > 2 * margin) & (np.abs(best - min_proba) > margin)


def _scan_judgement(pred, proba, ref_pred, ref_columns, valid, clear):
    """Per slot of one batch: (gap (B, T), wrong (B, T) bool). The class
    axis is reduced column by column (`ref_columns`: the reference's
    probabilities, classes first), many times faster than over a last
    axis of 3."""
    columns = np.moveaxis(proba, -1, 0)
    finite = functools.reduce(np.logical_and, (np.isfinite(c) for c in columns))
    gap = functools.reduce(np.maximum, (np.abs(c - r) for c, r in zip(columns, ref_columns)))
    gap = np.where(valid, gap, 0.0)
    gap = np.where(valid & ~finite, 1.0, gap)  # as far as two probabilities lie apart
    wrong = np.where(valid, ~finite | ((pred != ref_pred) & clear), pred != UNKNOWN)
    return gap, wrong


def judge(kept: List[tuple], refs: Dict[int, Tuple[np.ndarray, np.ndarray]],
          valid: Dict[int, np.ndarray], limits: dict, tie_margin: float, min_proba: float):
    """The numbers and the scans that failed, over the kept outputs
    (batch, pred, proba) against refs[batch] = (pred, proba). A scan
    fails where one of its answers is wrong or its gap passes a gap
    number's limit."""
    gap_limit = min(float(v) for k, v in limits.items() if k.startswith("proba_gap"))
    clear = {b: _clear(refs[b][1], min_proba, tie_margin) for b in refs}
    columns = {b: np.ascontiguousarray(np.moveaxis(refs[b][1], -1, 0)) for b in refs}
    gaps, wrong_total, failed = [], 0, 0
    for b, pred, proba in kept:
        gap, wrong = _scan_judgement(pred, proba, refs[b][0], columns[b], valid[b], clear[b])
        gaps.append(gap[valid[b]])
        wrong_total += int(wrong.sum())
        failed += int(((gap > gap_limit) | wrong).any(-1).sum())
    gaps = np.concatenate(gaps) if gaps else np.zeros(1)
    return {"proba_gap": float(gaps.max()),
            "proba_gap_p999": float(np.quantile(gaps, 0.999)),
            "wrong_answers": wrong_total}, failed


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit; a limit names a number here."""
    unknown = set(limits) - set(numbers)
    if unknown:
        raise KeyError(f"limits name numbers that are not compared: {sorted(unknown)}")
    return all(numbers[name] <= float(limit) for name, limit in limits.items())
