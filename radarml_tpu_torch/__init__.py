"""radarml_tpu_torch — the PyTorch/CUDA port of radarml_tpu for one NVIDIA H100.

The JAX package `radarml_tpu` stays the reference; this package mirrors
its layout and names so each module has an obvious counterpart, and the
tests hold each port module against its JAX twin on the same inputs.
The package imports torch and numpy only — never jax, never radarml_tpu.

Ported so far: the real-time predict path (RadarPredictor in every
mode, for linear models and the RBF SVC), the serving slice (radar
drivers, the predict and serve apps, the radar gRPC endpoint, hot
reload) and the training slice (dataset store, split, balance,
augmentation, SGD and SVC grid searches with calibration, metrics and
the train app).

Subpackages
-----------
core      arena geometry, coordinate transforms, derived targets
ops       resample operators, feature geometry, augmentation, the CUDA kernels
data      dataset store, split, balance, synthetic scans and datasets, labels
drivers   radar session protocol: synthetic, replay, native C++, Walabot
models    linear and SVC inference and training, the RadarPredictor
train     grid searches over the classical families, metrics
serving   StreamingClassifier, scan-source adapters, model hot reload
apps      the train, predict and serve command lines
rpc       the radar gRPC endpoint (the only part that imports grpc)
utils     stage timers, rate meters, profiler traces
"""

__version__ = "0.1.0"
