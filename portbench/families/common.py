"""What the model families share: the reference over a batch, in blocks of
targets, and the control's lower precision."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench.reference.arena import Arena
from portbench.reference.features import features
from portbench.reference.linear import UNKNOWN


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, ties to even), as
    the tensor cores round a product's operands with TF32 on."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


ROUNDINGS = {"tf32": tf32}


def arenas(cell):
    return Arena.from_dict(cell.traffic["scan_arena"]), Arena.from_dict(cell.config["train_arena"])


def reference(answers: Callable, cell, model: dict, cubes, xyz, valid,
              dtype=torch.float64, rounding: Optional[str] = None, block: int = 4096):
    """The reference's answers to one batch: pred (B, T) int64, UNKNOWN
    in an empty slot, and proba (B, T, C) in `dtype`, NaN in an empty
    slot. `answers(feats, model, valid, min_proba[, rounding])` scores a
    block of valid targets' features."""
    scan, train = arenas(cell)
    B, T = valid.shape
    C = len(cell.config["classes"])
    rnd = ROUNDINGS[rounding] if rounding else None
    kw = {"rounding": rnd} if rnd else {}
    pred = torch.full((B, T), UNKNOWN, dtype=torch.int64, device=cubes.device)
    proba = torch.full((B, T, C), float("nan"), dtype=dtype, device=cubes.device)
    b, t = valid.nonzero(as_tuple=True)
    ijk = scan.indices(xyz[b, t])
    for s in range(0, b.shape[0], block):
        e = min(b.shape[0], s + block)
        feats = features(cubes, b[s:e], [v[s:e] for v in ijk], scan, train, dtype, rnd)
        ones = torch.ones(e - s, dtype=torch.bool, device=cubes.device)
        p, pr = answers(feats, model, ones, float(cell.config["min_proba"]), **kw)
        pred[b[s:e], t[s:e]] = p
        proba[b[s:e], t[s:e]] = pr
    return pred, proba


def reference_program(answers: Callable, cell, model: dict, rounding: str) -> Callable:
    """The reference in float32 with `rounding` on every product's
    operands, in the program's place: (cubes, xyz, valid) → (pred int32,
    best, proba float32), zeros in an empty slot."""

    def call(cubes, xyz, valid):
        pred, proba = reference(answers, cell, model, cubes, xyz, valid, torch.float32, rounding)
        proba = torch.nan_to_num(proba, nan=0.0)
        return pred.to(torch.int32), proba.amax(-1), proba

    return call
