"""bag_ms: milliseconds per tree inside the forest driver's
`fit.bag_draw` range (each tree batch's Poisson bag draw, inside
`fit.bagging`): the union of its host intervals and its device spans."""
from drfbench import tracing

RANGES = ["fit.bag_draw"]


def read(run):
    t = run.trace
    iv = [x for nm in RANGES for side in (t.host_ranges, t.device_spans)
          for x in side.get(nm, ())] if t else []
    if not iv:
        return None
    return sum(hi - lo for lo, hi in tracing.merge(iv)) / 1e3 / run.trees
