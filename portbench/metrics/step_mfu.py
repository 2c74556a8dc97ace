"""step_mfu (device trace, whole step): the least time the
configuration's own math needs for the traced steps' valid targets
(the family's `least_step`: the bytes the targets' planes cover, the
model, the answers; the operations at the cheapest rate that holds the
configuration's precision) over the traced device window, in %."""


def read(run):
    if run.trace is None or not run.window.steps:
        return None
    slots = int(run.cell.traffic["slots"])
    least = 0.0
    for s in run.window.steps:
        b = run.batches[s.batch]
        least += run.cell.family.least_step(run.cell, b.n_valid, b.scans * slots, b.voxels)[0]
    return 100.0 * least / run.trace.window_s
