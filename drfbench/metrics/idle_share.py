"""idle_share: the share of the traced window in which no device operation
ran, in %."""


def read(run):
    t = run.trace
    if t is None or not t.busy:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
