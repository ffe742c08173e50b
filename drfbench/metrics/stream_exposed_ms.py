"""stream_exposed_ms: host milliseconds per tree inside the streamed
driver's `stream.read`, `stream.stage` and `stream.fetch` ranges that no
device operation overlapped."""
RANGES = ["stream.read", "stream.stage", "stream.fetch"]


def read(run):
    s = run.trace.exposed_s(RANGES) if run.trace else None
    return None if s is None else 1e3 * s / run.trees
