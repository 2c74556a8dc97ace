from radarml_tpu_torch.core.arena import (
    Arena,
    DEFAULT_ARENA,
    RADAR_MIN,
    RADAR_MAX,
    ProjMask,
    ProjZoom,
    cartesian_to_spherical,
    slice_projections,
)

__all__ = [
    "Arena",
    "DEFAULT_ARENA",
    "RADAR_MIN",
    "RADAR_MAX",
    "ProjMask",
    "ProjZoom",
    "cartesian_to_spherical",
    "slice_projections",
]
