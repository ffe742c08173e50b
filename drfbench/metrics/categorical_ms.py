"""categorical_ms: device milliseconds per tree inside the categorical
engine's ranges: `level.categorical` and the ranges nested in it (the
count tables and the Breiman scorer; the trace gives a device-side span to
the innermost range around each kernel)."""
RANGES = ["level.categorical", "level.cat_tables", "level.cat_breiman"]


def read(run):
    s = run.trace.span_s(RANGES) if run.trace else None
    return None if s is None else 1e3 * s / run.trees
