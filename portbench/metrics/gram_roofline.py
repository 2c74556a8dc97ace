"""gram_roofline (device trace, kernels): kernel B6's share of its
roofline at the cell's shapes: the least time of the Gram of the traced
steps' valid targets against the support vectors (bounds.rbf_gram, one
query row a valid target: the rows any route has to score) over the
device time of B6's three kernels (the main kernel and its two packs),
in %. Nothing to read where B6 did not run."""

from portbench import bounds

SYMBOLS = ("rbf_gram_kernel", "rbf_pack_kernel")


def read(run):
    if run.trace is None or not run.window.steps:
        return None
    us = sum(e - s for name, s, e in run.trace.kernels() if any(k in name for k in SYMBOLS))
    if us <= 0:
        return None
    cfg = run.cell.config
    m, F = sum(int(v) for v in cfg["n_support"]), int(cfg["n_features"])
    least = sum(bounds.rbf_gram(run.batches[s.batch].n_valid, m, F)[0] for s in run.window.steps)
    return 100.0 * least / (us / 1e6)
