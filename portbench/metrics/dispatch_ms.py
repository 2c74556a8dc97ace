"""dispatch_ms (host clock, predictor layer): the mean host time of the
predictor's call, from its start until it returns, before any
synchronise, over the steps of the traced window."""


def read(run):
    steps = run.window.steps
    return 1e3 * sum(s.dispatch_s for s in steps) / len(steps) if steps else None
