"""Pose iterations per frame: the port's "tracking.iters" counter (each
tracked frame's iterations run, 200 or 400 where the depth-loss rule
doubled the budget; frame 0 tracks none) over the untraced window's jobs
over their frames."""
from benchmark.counters import window_total


def read(ctx):
    n = window_total(ctx, "tracking.iters")
    return n / ctx["frames"] if n is not None else None
