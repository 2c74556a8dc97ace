"""setup_s (host clock): process start to the window's start: imports,
the model's inputs, the pool of scans, kernel builds or loads, warm-up."""


def read(run):
    return run.setup_s
