"""Checkpoint seconds per frame: the port's "checkpoint" spans (the map
read back and written as params<frame>.npz) summed over the untraced
window's jobs over their frames."""
from benchmark.spans import seconds_of, window_per_frame


def read(ctx):
    return window_per_frame(ctx, seconds_of("checkpoint"))
