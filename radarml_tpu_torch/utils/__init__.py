from radarml_tpu_torch.utils.profiling import RateMeter, StageTimer, device_trace

__all__ = ["RateMeter", "StageTimer", "device_trace"]
