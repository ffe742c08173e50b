"""copy_in_ms: milliseconds per tree inside the forest driver's
`fit.copy_in` range (the host columns onto the device): the union of its
host intervals and its device spans."""
from drfbench import tracing

RANGES = ["fit.copy_in"]


def read(run):
    t = run.trace
    iv = [x for nm in RANGES for side in (t.host_ranges, t.device_spans)
          for x in side.get(nm, ())] if t else []
    if not iv:
        return None
    return sum(hi - lo for lo, hi in tracing.merge(iv)) / 1e3 / run.trees
