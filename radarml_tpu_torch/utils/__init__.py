from radarml_tpu_torch.utils.profiling import RateMeter, StageTimer, device_trace
from radarml_tpu_torch.utils.summary import model_summary, plot_model_png, write_model_summary

__all__ = ["RateMeter", "StageTimer", "device_trace", "model_summary", "plot_model_png",
           "write_model_summary"]
