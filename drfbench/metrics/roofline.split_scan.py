"""roofline.split_scan: the least time of the split_scan kernel's work (the frozen
counts of `drfbench/counts.py` over every traced level) as a share of the
device time of its launches in the trace, in %."""
from drfbench import counts


def read(run):
    t = run.trace.kernel_s(counts.KERNELS["split_scan"]) if run.trace else None
    if t is None:
        return None
    least = counts.least_time(run.levels(), "split_scan", **run.shape())
    return None if least is None else 100.0 * least / t
