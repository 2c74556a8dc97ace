from radarml_tpu_torch.models.linear import (
    LinearModel,
    SigmoidCalibration,
    calibrated_from_decision,
    decision_function,
    from_numpy,
    predict,
    predict_proba_calibrated,
    predict_proba_log_loss,
    proba_from_decision,
)
from radarml_tpu_torch.models.svc import SVCConfig, SVCModel, svc_fit
from radarml_tpu_torch.models.pipeline import UNKNOWN, RadarPredictor, pad_targets

__all__ = [
    "LinearModel",
    "SigmoidCalibration",
    "calibrated_from_decision",
    "decision_function",
    "from_numpy",
    "predict",
    "predict_proba_calibrated",
    "predict_proba_log_loss",
    "proba_from_decision",
    "SVCConfig",
    "SVCModel",
    "svc_fit",
    "UNKNOWN",
    "RadarPredictor",
    "pad_targets",
]
