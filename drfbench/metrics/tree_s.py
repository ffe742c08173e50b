"""tree_s: seconds of the window (host clock, from its start to the end of
its last fit, which ends in a device sync) per tree its fits trained."""


def read(run):
    return run.window_s / run.trees
