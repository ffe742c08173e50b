"""presort_ms: milliseconds per tree inside the forest driver's
`fit.presort` and `fit.quantize` ranges (the presort of the numeric
columns, and hist mode's quantizer): the union of their host intervals
and their device spans."""
from drfbench import tracing

RANGES = ["fit.presort", "fit.quantize"]


def read(run):
    t = run.trace
    iv = [x for nm in RANGES for side in (t.host_ranges, t.device_spans)
          for x in side.get(nm, ())] if t else []
    if not iv:
        return None
    return sum(hi - lo for lo, hi in tracing.merge(iv)) / 1e3 / run.trees
