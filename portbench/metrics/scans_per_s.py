"""scans_per_s (host clock): every scan whose answers reached the host
inside the window, over the window's seconds."""


def read(run):
    return sum(run.batches[s.batch].scans for s in run.window.counted()) / run.seconds
