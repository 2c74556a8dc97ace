"""Shared CLI plumbing: logging, flags, drivers, model artifacts.

Port of radarml_tpu/apps/common_cli.py.

- Logging: the reference's format string, FileHandler(mode='w') plus a
  stdout StreamHandler, info/debug level flag.
- `--platform` picks the torch device: "" (the default) is the CUDA
  card, "cpu" the CPU. `device_of(args)` resolves it, and without a card
  the default raises instead of carrying on quietly on the CPU.
- Model artifacts are the `radarml_tpu.v1` pickles of the JAX package:
  a pickled dict {"format": "radarml_tpu.v1", "kind": ..., arrays...}
  whose arrays are numpy, so one that the JAX package trained loads
  here and serves on the card. `linear` and `svc` load as the port's
  models; `cnn` (a MultiViewCNN's flax params) and `sgan_classifier` (a
  Discriminator's flax params and batch stats) load as NeuralClassifiers,
  the weights carried into the port's modules (models/cnn.py,
  models/sgan.py). The port's dnn and sgan apps write those two kinds
  with the same keys and tree layout, so the JAX package loads them.
  Label encoders are v1 dicts {"format", "classes"}.
- Reference sklearn pickles (models and label encoders) raise
  NotImplementedError (ROADMAP A4): sklearn is not installed where the
  port runs, and the port never imports it.

Loading unpickles with an allow-list (numpy arrays and plain Python
containers); any other class is refused before it is imported.
"""

from __future__ import annotations

import argparse
import functools
import logging
import os
import pickle
import sys
from typing import List, Optional, Sequence, Tuple, Union

import torch

from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena, ProjMask
from radarml_tpu_torch.core.device import resolve_device
from radarml_tpu_torch.data.labels import LabelEncoder
from radarml_tpu_torch.drivers.base import DEFAULT_THRESHOLD
from radarml_tpu_torch.models.linear import LinearModel, SigmoidCalibration
from radarml_tpu_torch.models.linear import from_numpy as linear_from_numpy
from radarml_tpu_torch.models.pipeline import NeuralClassifier
from radarml_tpu_torch.models.svc import SVCModel
from radarml_tpu_torch.models.svc import from_numpy as svc_from_numpy

__all__ = [
    "FORMAT",
    "LOG_FORMAT",
    "add_common_flags",
    "add_driver_flags",
    "add_scan_arena_flag",
    "build_driver",
    "device_of",
    "load_label_encoder",
    "load_model",
    "load_model_meta",
    "neural_classifier",
    "parse_arena",
    "parse_proj_mask",
    "save_label_encoder",
    "save_model",
    "setup_logging",
    "warm_transfers",
]

FORMAT = "radarml_tpu.v1"
LOG_FORMAT = "%(asctime)s %(name)-12s %(levelname)-8s %(message)s"

_BUILTINS = frozenset({
    "dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
    "str", "bytes", "bytearray", "bool", "slice", "range",
})


def setup_logging(log_file: Optional[str], level: str):
    handlers: List[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file, mode="w"))
    logging.basicConfig(
        format=LOG_FORMAT,
        level=logging.DEBUG if level == "debug" else logging.INFO,
        handlers=handlers,
        force=True,
    )


def add_common_flags(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--logging_level", type=str, default="info",
        help='logging level, "info" or "debug"',
    )
    parser.add_argument(
        "--platform", type=str, default="",
        help="torch device to compute on: '' (default) is the CUDA card, "
             "and raises where there is none; 'cpu' is the CPU",
    )


def device_of(args) -> torch.device:
    """The device `--platform` picks: the card unless it says 'cpu'.
    Without a card the default raises; it never falls back to the CPU."""
    try:
        return resolve_device(args.platform or None)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (on the command line: --platform cpu)") from e


def warm_transfers(device: torch.device) -> None:
    """One small host→device→host round trip. On the card it also
    creates the CUDA context, so the first batch does not pay for it."""
    (torch.zeros(8, device=device) + 1.0).cpu()


def parse_proj_mask(values: Sequence) -> ProjMask:
    """Reference flag order is (xz, yz, xy) booleans."""
    vals = [v if isinstance(v, bool) else _parse_bool(v) for v in values]
    if len(vals) != 3:
        raise ValueError("--proj_mask needs exactly 3 values")
    return ProjMask(*vals)


def add_scan_arena_flag(parser: argparse.ArgumentParser):
    """--scan_arena: serve scans from a differently configured arena.

    The reference predictor classifies scans from an arena that may
    differ from the training arena: it zooms each projection by
    train_size/scan_size per axis (reference predict.py:34-54
    calc_proj_zoom; here ops/features.predict_zoom through
    RadarPredictor(scan_arena=...)).
    """
    parser.add_argument(
        "--scan_arena", type=str, default="",
        help="scan arena if it differs from the training arena, as "
             "9 comma-separated values "
             "r_min,r_max,r_res,theta_min,theta_max,theta_res,"
             "phi_min,phi_max,phi_res (cm / deg; default: the "
             "training arena, i.e. 10,360,2,-42,42,4,-30,30,2)",
    )


def parse_arena(spec: str, default: Arena = DEFAULT_ARENA) -> Arena:
    """Parse a --scan_arena value; '' → the default (training) arena."""
    if not spec:
        return default
    vals = [float(v) for v in spec.replace(" ", "").split(",")]
    if len(vals) != 9:
        raise ValueError(
            "--scan_arena needs 9 comma-separated values "
            "(r_min,r_max,r_res,theta_min,theta_max,theta_res,"
            "phi_min,phi_max,phi_res); got %d" % len(vals)
        )
    return Arena(
        r_min=vals[0], r_max=vals[1], r_res=vals[2],
        theta_min=vals[3], theta_max=vals[4], theta_res=vals[5],
        phi_min=vals[6], phi_max=vals[7], phi_res=vals[8],
    )


def _parse_bool(value) -> bool:
    return str(value).lower() not in ("0", "false", "no", "")


def add_driver_flags(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--driver", type=str, default="synthetic",
        choices=["synthetic", "native", "walabot"],
        help="radar backend (walabot requires the vendor SDK)",
    )
    parser.add_argument(
        "--scan_period", type=float, default=0.0,
        help="simulated sensor scan period in seconds",
    )
    parser.add_argument("--driver_seed", type=int, default=1234)
    parser.add_argument(
        "--threshold", type=float, default=DEFAULT_THRESHOLD,
        help="radar sensitivity threshold applied at session configure "
             "(reference predict.py:203 SetThreshold(5))",
    )
    parser.add_argument(
        "--mti", type=_parse_bool, default=True,
        help="enable the MTI dynamic image filter; with --mti=false the "
             "session runs the explicit calibration loop before scanning "
             "(reference predict.py:207-213 SetDynamicImageFilter + "
             "common.calibrate)",
    )


def build_driver(args, arena: Arena = DEFAULT_ARENA):
    threshold = getattr(args, "threshold", DEFAULT_THRESHOLD)
    mti = getattr(args, "mti", True)
    if args.driver == "synthetic":
        from radarml_tpu_torch.drivers import SyntheticRadar

        return SyntheticRadar(
            arena=arena, seed=args.driver_seed,
            scan_period_s=args.scan_period, max_targets=2,
            threshold=threshold, mti=mti,
        )
    if args.driver == "native":
        from radarml_tpu_torch.drivers import NativeRadar

        return NativeRadar(
            arena=arena, seed=args.driver_seed,
            scan_period_us=args.scan_period * 1e6,
            threshold=threshold, mti=mti,
        )
    from radarml_tpu_torch.drivers import WalabotRadar, walabot_available

    if not walabot_available():
        raise SystemExit(
            "walabot driver requires the vendor WalabotAPI SDK wheel"
        )
    return WalabotRadar(arena=arena, threshold=threshold, mti=mti)


# --------------------------------------------------------------------------
# Model artifacts
# --------------------------------------------------------------------------

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


def save_label_encoder(path: str, le: LabelEncoder) -> None:
    """Write a label encoder in the JAX package's v1 format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fp:
        pickle.dump({"format": FORMAT, "classes": list(le.classes_)}, fp)


def load_label_encoder(path: str) -> LabelEncoder:
    """Read a v1 label encoder; a reference sklearn pickle is refused
    (NotImplementedError, ROADMAP A4) before sklearn is imported."""
    obj = _load(path)
    if not (isinstance(obj, dict) and obj.get("format") == FORMAT):
        raise ValueError(f"{path} is not a {FORMAT} label encoder")
    return LabelEncoder(classes_=tuple(str(c) for c in obj["classes"]))


def load_model_meta(path: str) -> dict:
    """Raw artifact payload of a v1 pickle; {} for anything else."""
    obj = _load(path)
    if isinstance(obj, dict) and obj.get("format") == FORMAT:
        return obj
    return {}


def load_model(
    path: str, device: torch.device | str | None = None
) -> Tuple[Union[LinearModel, SVCModel, NeuralClassifier], Optional[SigmoidCalibration]]:
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
    if kind == "cnn":
        from radarml_tpu_torch.models.cnn import MultiViewCNN, cnn_params_from_numpy

        module = MultiViewCNN(len(obj["classes"]), tuple(obj["rescale"]))
        module.load_state_dict(cnn_params_from_numpy(obj["params"]))
        return neural_classifier(module, obj["rescale"], device), None
    if kind == "sgan_classifier":
        from radarml_tpu_torch.models.sgan import Discriminator, sgan_params_from_numpy

        module = Discriminator(len(obj["classes"]), tuple(obj["rescale"]))
        module.load_state_dict(sgan_params_from_numpy(obj["d_params"], obj["d_stats"]))
        return neural_classifier(module, obj["rescale"], device), None
    raise ValueError(f"unknown model kind {kind!r}")


def neural_classifier(module: torch.nn.Module, rescale, device=None) -> NeuralClassifier:
    """A MultiViewCNN or a Discriminator, moved to `device` (default: the
    card), as a NeuralClassifier that runs it in inference mode."""
    from radarml_tpu_torch.models.sgan import Discriminator

    dev = resolve_device(device)
    module = module.to(dev)
    apply = functools.partial(module, train=False) if isinstance(module, Discriminator) \
        else module
    return NeuralClassifier(apply=apply, rescale=tuple(int(r) for r in rescale),
                            n_classes=module.n_classes, device=dev)
