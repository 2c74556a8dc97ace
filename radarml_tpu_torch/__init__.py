"""radarml_tpu_torch — the PyTorch/CUDA port of radarml_tpu for one NVIDIA H100.

The JAX package `radarml_tpu` stays the reference; this package mirrors
its layout and names so each module has an obvious counterpart, and the
tests hold each port module against its JAX twin on the same inputs.
The package imports torch and numpy only — never jax, never radarml_tpu.

Ported so far: the real-time predict path (RadarPredictor in every
mode, for linear models and the RBF SVC), the serving slice (radar
drivers, the predict and serve apps, the radar gRPC endpoint, hot
reload) and the SVC fit.

Subpackages
-----------
core      arena geometry, coordinate transforms, derived targets
ops       resample operators, feature geometry, the hand-written CUDA kernels
data      synthetic scan cubes and datasets, label encoding
drivers   radar session protocol: synthetic, replay, native C++, Walabot
models    linear and SVC inference, the SVC fit, the RadarPredictor
serving   StreamingClassifier, scan-source adapters, model hot reload
apps      the predict and serve command lines
rpc       the radar gRPC endpoint (the only part that imports grpc)
utils     stage timers, rate meters, profiler traces
"""

__version__ = "0.1.0"
