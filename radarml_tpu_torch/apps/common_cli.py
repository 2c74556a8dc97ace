"""Model artifacts: the `radarml_tpu.v1` pickles of the JAX package.

Port of the model-artifact half of radarml_tpu/apps/common_cli.py
(`save_model`, `load_model_meta`, `load_model`). An artifact is a
pickled dict {"format": "radarml_tpu.v1", "kind": ..., arrays...} whose
arrays are numpy, so one that the JAX package trained loads here and
serves on the card.

- `linear` and `svc` load as the port's models.
- `cnn` and `sgan_classifier` raise NotImplementedError (ROADMAP A12,
  A13).
- Reference sklearn pickles raise NotImplementedError (ROADMAP A4):
  sklearn is not installed where the port runs, and the port never
  imports it.

Loading unpickles with an allow-list (numpy arrays and plain Python
containers); any other class is refused before it is imported.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple, Union

import torch

from radarml_tpu_torch.models.linear import LinearModel, SigmoidCalibration
from radarml_tpu_torch.models.linear import from_numpy as linear_from_numpy
from radarml_tpu_torch.models.svc import SVCModel
from radarml_tpu_torch.models.svc import from_numpy as svc_from_numpy

__all__ = ["FORMAT", "load_model", "load_model_meta", "save_model"]

FORMAT = "radarml_tpu.v1"

_BUILTINS = frozenset({
    "dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
    "str", "bytes", "bytearray", "bool", "slice", "range",
})
_NOT_PORTED = {
    "cnn": "the CNN family is not ported yet (ROADMAP A12)",
    "sgan_classifier": "the SGAN classifier is not ported yet (ROADMAP A13)",
}


class _ArtifactUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and plain containers; refuses the rest."""

    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root == "numpy":
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if module == "collections" and name == "OrderedDict":
            return super().find_class(module, name)
        if root == "sklearn":
            raise NotImplementedError(
                f"reference sklearn pickles ({module}.{name}) are not ported "
                "(ROADMAP A4): sklearn is not installed where the port runs"
            )
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} from a model artifact"
        )


def _load(path: str):
    with open(path, "rb") as fp:
        return _ArtifactUnpickler(fp).load()


def save_model(path: str, kind: str, **arrays) -> None:
    """Write a `radarml_tpu.v1` artifact (the JAX package's format)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"format": FORMAT, "kind": kind}
    payload.update(arrays)
    with open(path, "wb") as fp:
        pickle.dump(payload, fp)


def load_model_meta(path: str) -> dict:
    """Raw artifact payload of a v1 pickle; {} for anything else."""
    obj = _load(path)
    if isinstance(obj, dict) and obj.get("format") == FORMAT:
        return obj
    return {}


def load_model(
    path: str, device: torch.device | str | None = None
) -> Tuple[Union[LinearModel, SVCModel], Optional[SigmoidCalibration]]:
    """Load a scoring model onto `device` (default: the CUDA card; pass
    "cpu" for the CPU): (model, calibration or None)."""
    obj = _load(path)
    if not (isinstance(obj, dict) and obj.get("format") == FORMAT):
        raise NotImplementedError(
            f"{path} is not a {FORMAT} artifact; reference sklearn pickles "
            "are not ported (ROADMAP A4)"
        )
    kind = obj["kind"]
    if kind == "linear":
        return linear_from_numpy(
            obj["coef"], obj["intercept"], obj.get("calib_a"),
            obj.get("calib_b"), device=device,
        )
    if kind == "svc":
        return svc_from_numpy(
            obj["support_vectors"], obj["dual_coef"], obj["intercept"],
            obj["n_support"], kernel=obj["kernel"], gamma=float(obj["gamma"]),
            probA=obj.get("probA"), probB=obj.get("probB"), device=device,
        ), None
    if kind in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[kind])
    raise ValueError(f"unknown model kind {kind!r}")
