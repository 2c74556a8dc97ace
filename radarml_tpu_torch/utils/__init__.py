from radarml_tpu_torch.utils.profiling import RateMeter, StageTimer

__all__ = ["RateMeter", "StageTimer"]
