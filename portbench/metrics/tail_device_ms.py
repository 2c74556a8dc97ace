"""tail_device_ms (device trace, fused tail): device ms a step of every
kernel but B1: the stream's encode and the fused tail (dequantize, look
up, Platt, argmax, threshold) and the target indexing. Nothing to read
where B1 did not run."""

B1 = "combo_tables_kernel"


def read(run):
    if run.trace is None or not run.window.steps:
        return None
    kernels = run.trace.kernels()
    if not any(B1 in name for name, _, _ in kernels):
        return None
    us = sum(e - s for name, s, e in kernels if B1 not in name)
    return us / 1e3 / len(run.window.steps)
