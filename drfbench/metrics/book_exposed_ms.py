"""book_exposed_ms: host milliseconds per tree inside the tree driver's
`level.book` ranges (node values, tree growth, level stats) that no device
operation overlapped."""


def read(run):
    s = run.trace.exposed_s(["level.book"]) if run.trace else None
    return None if s is None else 1e3 * s / run.trees
