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
- The reference's own sklearn pickles load too, without sklearn (it is
  not installed where the port runs, and the port never imports it): a
  `CalibratedClassifierCV` over a linear estimator (the reference's
  `svm_radar_classifier.pickle`) through `models.linear.
  from_sklearn_calibrated`, an `SVC` through `models.svc.
  from_sklearn_svc`, and a `LabelEncoder` (`radar_labels.pickle`) as its
  `classes_`.

Loading unpickles with an allow-list; every other global is refused
with `pickle.UnpicklingError` before it is imported, and nothing but
the following is ever looked up or called:
- numpy's array, dtype and scalar reconstructors, `ndarray`, `dtype`,
  `_reconstruct`, `scalar` and (protocol 5) `_frombuffer`, under numpy
  1's `numpy.core.*` and numpy 2's `numpy._core.*` spellings alike, each
  mapped to the installed numpy's object. Any other numpy global (a
  function such as `numpy.load` or `numpy.testing`'s `runstring`) is
  refused;
- the builtin containers and scalars (`dict`, `list`, `tuple`, `set`,
  `frozenset`, `int`, `float`, `complex`, `str`, `bytes`, `bytearray`,
  `bool`, `slice`, `range`) and `collections.OrderedDict`;
- the sklearn classes of `SKLEARN_CLASSES` (`CalibratedClassifierCV`,
  `_CalibratedClassifier`, `_SigmoidCalibration`, `FrozenEstimator`,
  `SGDClassifier`, `SVC`, `LabelEncoder`, under their current modules
  and their pre-0.22 public ones) and the Cython loss objects of an
  `SGDClassifier`'s state (any name in `sklearn._loss._loss`,
  `sklearn.linear_model._sgd_fast` or the pre-0.22
  `sklearn.linear_model.sgd_fast`). Each loads as an `SklearnState`: an
  inert holder named after the class that keeps the attributes its
  pickled state sets, swallows constructor arguments and has no other
  behaviour. No module of sklearn is imported.
Pickles of protocol 3 and up (Python 3's defaults) are read; at
protocols 0-2 these objects' pickles name `copyreg` or `_codecs`
helpers, which are refused with the rest.
"""

from __future__ import annotations

import argparse
import functools
import logging
import os
import pickle
import sys
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena, ProjMask
from radarml_tpu_torch.core.device import resolve_device
from radarml_tpu_torch.data.labels import LabelEncoder
from radarml_tpu_torch.drivers.base import DEFAULT_THRESHOLD
from radarml_tpu_torch.models.linear import LinearModel, SigmoidCalibration
from radarml_tpu_torch.models.linear import from_numpy as linear_from_numpy
from radarml_tpu_torch.models.linear import from_sklearn_calibrated
from radarml_tpu_torch.models.pipeline import NeuralClassifier
from radarml_tpu_torch.models.svc import SVCModel
from radarml_tpu_torch.models.svc import from_numpy as svc_from_numpy
from radarml_tpu_torch.models.svc import from_sklearn_svc

__all__ = [
    "FORMAT",
    "LOG_FORMAT",
    "SKLEARN_CLASSES",
    "SklearnState",
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

class SklearnState:
    """An sklearn object's pickled state, held without sklearn.

    Subclasses are named after the sklearn class the pickle named
    (`sklearn_class` keeps its full name), so `type(obj).__name__` reads
    as sklearn's. The state's entries become attributes; constructor
    arguments (the Cython loss objects') are swallowed. Nothing else: no
    method of sklearn runs, and nothing is imported."""

    sklearn_class = ""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # a Cython object's own state: kept, never read
            self.__dict__["_state"] = state


# (module, name) -> the class's current full name. The reference's
# Raspberry Pi pickles carry the pre-0.22 public module spellings.
SKLEARN_CLASSES = {
    ("sklearn.calibration", "CalibratedClassifierCV"):
        "sklearn.calibration.CalibratedClassifierCV",
    ("sklearn.calibration", "_CalibratedClassifier"):
        "sklearn.calibration._CalibratedClassifier",
    ("sklearn.calibration", "_SigmoidCalibration"):
        "sklearn.calibration._SigmoidCalibration",
    ("sklearn.frozen._frozen", "FrozenEstimator"): "sklearn.frozen._frozen.FrozenEstimator",
    ("sklearn.linear_model._stochastic_gradient", "SGDClassifier"):
        "sklearn.linear_model._stochastic_gradient.SGDClassifier",
    ("sklearn.linear_model.stochastic_gradient", "SGDClassifier"):
        "sklearn.linear_model._stochastic_gradient.SGDClassifier",
    ("sklearn.svm._classes", "SVC"): "sklearn.svm._classes.SVC",
    ("sklearn.svm.classes", "SVC"): "sklearn.svm._classes.SVC",
    ("sklearn.preprocessing._label", "LabelEncoder"):
        "sklearn.preprocessing._label.LabelEncoder",
    ("sklearn.preprocessing.label", "LabelEncoder"):
        "sklearn.preprocessing._label.LabelEncoder",
}
# Modules whose every class is a Cython loss object of an SGDClassifier's
# state: held, never called.
SKLEARN_LOSS_MODULES = frozenset({
    "sklearn._loss._loss", "sklearn.linear_model._sgd_fast",
    "sklearn.linear_model.sgd_fast",
})


def _sklearn_holder(full_name: str) -> type:
    name = full_name.rpartition(".")[2]
    return type(name, (SklearnState,), {"sklearn_class": full_name,
                                         "__module__": __name__, "__qualname__": name})


def _numpy_globals() -> dict:
    """(module, name) -> the installed numpy's array, dtype and scalar
    reconstructors, under numpy 1's and numpy 2's module spellings."""
    try:
        from numpy._core import multiarray, numeric
    except ImportError:  # numpy 1 before numpy._core existed
        from numpy.core import multiarray, numeric
    table = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype}
    for core in ("numpy.core", "numpy._core"):
        table[(f"{core}.multiarray", "_reconstruct")] = multiarray._reconstruct
        table[(f"{core}.multiarray", "scalar")] = multiarray.scalar
        table[(f"{core}.numeric", "_frombuffer")] = numeric._frombuffer
    return table


_NUMPY_GLOBALS = _numpy_globals()


class _ArtifactUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays, plain containers and the allowed sklearn
    classes (as SklearnState holders); refuses every other global before
    it is imported (see the module docstring)."""

    def find_class(self, module: str, name: str):
        if (module, name) in _NUMPY_GLOBALS:
            return _NUMPY_GLOBALS[(module, name)]
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if module == "collections" and name == "OrderedDict":
            return super().find_class(module, name)
        if (module, name) in SKLEARN_CLASSES:
            return _sklearn_holder(SKLEARN_CLASSES[(module, name)])
        if module in SKLEARN_LOSS_MODULES and name.isidentifier():
            return _sklearn_holder(f"{module}.{name}")
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
    """Read a v1 label encoder or a reference sklearn LabelEncoder pickle
    (its `classes_` as str)."""
    obj = _load(path)
    if isinstance(obj, dict) and obj.get("format") == FORMAT:
        classes = obj["classes"]
    elif type(obj).__name__ == "LabelEncoder":  # only a holder has this name
        classes = obj.classes_
    else:
        raise ValueError(f"{path} is neither a {FORMAT} nor an sklearn label encoder")
    return LabelEncoder(classes_=tuple(str(c) for c in classes))


def load_model_meta(path: str) -> dict:
    """Raw artifact payload of a v1 pickle; {} for anything else (a
    reference sklearn pickle keeps its hyperparameters in the estimator
    instead). Online learning resumes the SGD schedule from it."""
    obj = _load(path)
    if isinstance(obj, dict) and obj.get("format") == FORMAT:
        return obj
    return {}


def load_model(
    path: str, device: torch.device | str | None = None
) -> Tuple[Union[LinearModel, SVCModel, NeuralClassifier], Optional[SigmoidCalibration]]:
    """Load a scoring model onto `device` (default: the CUDA card; pass
    "cpu" for the CPU): (model, calibration or None).

    Reads the v1 artifacts and the reference's sklearn pickles
    (CalibratedClassifierCV over a linear estimator; SVC)."""
    obj = _load(path)
    if not (isinstance(obj, dict) and obj.get("format") == FORMAT):
        cls = type(obj).__name__  # an sklearn holder's is sklearn's
        if cls == "CalibratedClassifierCV":
            return from_sklearn_calibrated(obj, device=device)
        if cls == "SVC":
            return from_sklearn_svc(obj, device=device), None
        raise ValueError(f"unrecognized model artifact {cls!r} in {path}")
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
