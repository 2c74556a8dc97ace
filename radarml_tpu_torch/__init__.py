"""radarml_tpu_torch — the PyTorch/CUDA port of radarml_tpu for one NVIDIA H100.

The JAX package `radarml_tpu` stays the reference; this package mirrors
its layout and names so each module has an obvious counterpart, and the
tests hold each port module against its JAX twin on the same inputs.
The package imports torch and numpy only — never jax, never radarml_tpu.

Ported so far: the real-time predict path (RadarPredictor in the exact,
fast and fused/combo modes) and its streaming service.

Subpackages
-----------
core      arena geometry, coordinate transforms
ops       resample operators, feature geometry, the int8 one-pass table kernel
data      synthetic scan cubes and datasets
models    linear inference, the RadarPredictor
serving   StreamingClassifier
utils     stage timers, rate meters
"""

__version__ = "0.1.0"
