"""The kernel-SVM family: libsvm's one-vs-one RBF SVC with Platt
probabilities, served by the program's RadarPredictor."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from portbench import bounds, scenes
from portbench.families import common
from portbench.reference import svc as ref
from portbench.reference.features import features


def support_vectors(cell, device) -> torch.Tensor:
    """(n_sv, F) float32: one-target scenes of the training arena drawn
    from the model seed, n_support[c] of class c in class order, each the
    target's three planes / 255."""
    cfg = cell.config
    sv = cfg["support_vectors"]
    _, train = common.arenas(cell)
    n_support = [int(n) for n in cfg["n_support"]]
    n = sum(n_support)
    gen = scenes.generator(sv["seed"], device)
    ones = torch.ones(n, dtype=torch.long, device=device)
    cells, _, valid = scenes.draw_targets(gen, ones, 1, cfg["classes"], train)
    cls = torch.repeat_interleave(torch.arange(len(n_support), device=device),
                                  torch.tensor(n_support, device=device))[:, None]
    rows = torch.arange(n, device=device)
    feats = torch.empty((n, int(cfg["n_features"])), dtype=torch.float32, device=device)
    block = scenes.block_of(train)
    for s in range(0, n, block):
        e = min(n, s + block)
        cubes = scenes.render(gen, cells[s:e], cls[s:e], valid[s:e], cfg["classes"], train,
                              float(sv["noise_level"]))
        feats[s:e] = features(cubes, rows[:e - s], cells[s:e, 0].unbind(-1), train, train,
                              torch.float32)
    return feats


def model(cell, device) -> dict:
    """The frozen coefficients and the support vectors made here: what
    both the program and the reference are given."""
    cfg = cell.config
    with np.load(cell.config_file("weights")) as z:
        m = {k: np.asarray(z[k], np.float32) for k in ("dual_coef", "intercept", "probA", "probB")}
        if [int(v) for v in z["n_support"]] != [int(v) for v in cfg["n_support"]]:
            raise ValueError("the frozen coefficients' n_support is not the configuration's")
    m.update(n_support=[int(v) for v in cfg["n_support"]], gamma=float(cfg["gamma"]),
             support_vectors=support_vectors(cell, device))
    return m


def program(cell, m: dict, device) -> Callable:
    """The program's predictor of this configuration on `device`."""
    from radarml_tpu_torch.core.arena import Arena
    from radarml_tpu_torch.models.pipeline import RadarPredictor
    from radarml_tpu_torch.models.svc import SVCModel

    def t(name):
        return torch.as_tensor(m[name], dtype=torch.float32, device=device)

    svc = SVCModel(support_vectors=m["support_vectors"].to(device), dual_coef=t("dual_coef"),
                   intercept=t("intercept"), n_support=tuple(m["n_support"]),
                   kernel=cell.config["kernel"], gamma=m["gamma"], probA=t("probA"),
                   probB=t("probB"))
    return RadarPredictor(train_arena=Arena(**cell.config["train_arena"]),
                          scan_arena=Arena(**cell.traffic["scan_arena"]), model=svc,
                          min_proba=float(cell.config["min_proba"]), device=device,
                          **cell.config["serve"])


def control(cell, m: dict, device) -> Callable:
    """The reference in float32 with TF32 products, in the program's place."""
    return common.reference_program(ref.answers, cell, m, cell.config["control"]["rounding"])


def reference(cell, m: dict, cubes, xyz, valid):
    return common.reference(ref.answers, cell, m, cubes, xyz, valid)


def least_step(cell, n_valid: int, n_slots: int, voxels: int):
    scan, train = common.arenas(cell)
    return bounds.svc_step(n_valid, n_slots, voxels, scan.planes, train.planes,
                           len(cell.config["classes"]), int(cell.config["n_features"]),
                           sum(int(v) for v in cell.config["n_support"]))
