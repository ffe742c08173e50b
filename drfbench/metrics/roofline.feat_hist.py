"""roofline.feat_hist: the least time of the feat_hist kernel's work (the frozen
counts of `drfbench/counts.py` over every traced level) as a share of the
device time of its launches in the trace, in %."""
from drfbench import counts


def read(run):
    t = run.trace.kernel_s(counts.KERNELS["feat_hist"]) if run.trace else None
    if t is None:
        return None
    least = counts.least_time(run.levels(), "feat_hist", **run.shape())
    return None if least is None else 100.0 * least / t
