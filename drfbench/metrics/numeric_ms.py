"""numeric_ms: device milliseconds per tree inside the numeric engines'
ranges: `level.numeric` and the ranges nested in it (the trace gives a
device-side span to the innermost range around each kernel), and the
streamed driver's table and score ranges, which lie outside it."""
RANGES = ["level.numeric", "level.segment_score", "level.hist_tables",
          "level.hist_score"]


def read(run):
    s = run.trace.span_s(RANGES) if run.trace else None
    return None if s is None else 1e3 * s / run.trees
