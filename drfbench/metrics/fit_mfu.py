"""fit_mfu: the least time the level steps of the traced fits need (the
frozen counts of `drfbench/counts.py`, over every level of every traced
tree) as a share of those fits' host wall time, in %.  A level does no
matrix product, so this is a roofline share of the whole fit."""
from drfbench import counts


def read(run):
    least = counts.least_time(run.levels(), "level", **run.shape())
    wall = sum(f.wall_s for f in run.fits)
    return None if least is None else 100.0 * least / wall
