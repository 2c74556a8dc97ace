"""i8_roofline (device trace, kernels): kernel B1's share of its roofline
at the cell's shapes: the least time of its work (bounds.int8_tables)
over its device time a step, in %. Nothing to read where B1 did not run."""

from portbench import bounds
from portbench.reference.arena import Arena

SYMBOL = "combo_tables_kernel"


def read(run):
    if run.trace is None or not run.window.steps:
        return None
    us = sum(e - s for name, s, e in run.trace.kernels() if SYMBOL in name)
    if us <= 0:
        return None
    cfg, traffic = run.cell.config, run.cell.traffic
    levels = 1 if cfg["serve"].get("fused_quant") == "single" else 2
    c2 = levels * len(cfg["classes"])
    dims = Arena.from_dict(traffic["scan_arena"]).shape
    least = bounds.int8_tables(int(traffic["batch"]), dims, c2)[0]
    return 100.0 * least / (us / 1e6 / len(run.window.steps))
