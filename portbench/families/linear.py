"""The linear family: a calibrated one-vs-rest linear model over the three
planes' features, served by the program's RadarPredictor."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from portbench import bounds
from portbench.families import common
from portbench.reference import linear as ref


def model(cell, device) -> dict:
    """The frozen weights, as numpy arrays."""
    if not all(cell.config["proj_mask"]):
        raise ValueError("the reference scores all three planes")
    with np.load(cell.config_file("weights")) as z:
        return {k: np.asarray(z[k], np.float32) for k in ("coef", "intercept", "calib_a",
                                                         "calib_b")}


def program(cell, weights: dict, device, overrides: Optional[dict] = None) -> Callable:
    """The program's predictor of this configuration on `device`."""
    from radarml_tpu_torch.core.arena import Arena, ProjMask
    from radarml_tpu_torch.models.linear import from_numpy
    from radarml_tpu_torch.models.pipeline import RadarPredictor

    lin, calib = from_numpy(weights["coef"], weights["intercept"], weights["calib_a"],
                            weights["calib_b"], device=device)
    serve = dict(cell.config["serve"], **(overrides or {}))
    return RadarPredictor(train_arena=Arena(**cell.config["train_arena"]),
                          scan_arena=Arena(**cell.traffic["scan_arena"]), model=lin,
                          calibration=calib, proj_mask=ProjMask(*cell.config["proj_mask"]),
                          min_proba=float(cell.config["min_proba"]), device=device, **serve)


def control(cell, weights: dict, device) -> Callable:
    """The program with its own next lower precision switched on."""
    return program(cell, weights, device, cell.config["control"])


def reference(cell, weights: dict, cubes, xyz, valid):
    return common.reference(ref.answers, cell, weights, cubes, xyz, valid)


def least_step(cell, n_valid: int, n_slots: int, voxels: int):
    scan, train = common.arenas(cell)
    return bounds.linear_step(n_valid, n_slots, voxels, scan.planes, train.planes,
                              len(cell.config["classes"]), int(cell.config["n_features"]))
