"""radarml_tpu_torch — the PyTorch/CUDA port of radarml_tpu for one NVIDIA H100.

The JAX package `radarml_tpu` stays the reference; this package mirrors
its layout and names so each module has an obvious counterpart, and the
tests hold each port module against its JAX twin on the same inputs.
The package imports torch and numpy only — never jax, never radarml_tpu.

Every module of the JAX package has a counterpart here but
utils/mosaic_gate.py (a Mosaic compiler probe; the port has no fallback
path): the real-time predict path (RadarPredictor in every mode, for
linear models, the RBF SVC and the neural families), serving (radar
drivers, the predict and serve apps, the radar gRPC endpoint, hot
reload, the exported serving artifact), training (dataset store, split,
balance, augmentation, SGD and SVC grid searches with calibration, the
CNN and SGAN trainers and their apps), ground-truth capture, the plots,
and the multi-device layer: one process per rank on torch.distributed,
with sharded serving, data-parallel CNN and SGAN training and sharded
grid searches.

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
rpc       the radar gRPC endpoint, the camera link (the only part that imports grpc)
fusion    radar and camera association, ground-truth capture
viz       dataset plots and the dataset browser
parallel  process groups, the mesh, batch placement, the data-parallel step
utils     stage timers, rate meters, profiler traces, slope timing, watchdog
"""

__version__ = "0.1.0"
