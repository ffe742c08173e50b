"""plan_ms: device milliseconds per tree inside the level plan's ranges:
the candidate draw, the reassignment, the next totals and the leaf-order
partition."""
RANGES = ["level.candidates", "level.reassign", "level.next_totals",
          "level.partition"]


def read(run):
    s = run.trace.span_s(RANGES) if run.trace else None
    return None if s is None else 1e3 * s / run.trees
