"""unnamed_idle_ms: idle device milliseconds per tree that the trace puts
down to the forest driver's `fit.forest` range with no narrower range
open: the fit's idle time the program does not yet name."""
RANGE = "fit.forest"


def read(run):
    t = run.trace
    if t is None or RANGE not in t.host_ranges:
        return None
    us = sum(v for k, v in t.idle_by_host.items()
             if k == RANGE or k.startswith(RANGE + " / "))
    return us / 1e3 / run.trees
