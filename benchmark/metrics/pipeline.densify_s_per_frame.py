"""Densification seconds per frame: the port's "densify" spans (the new
rows of every map_every-th frame, up to the wait before mapping) summed
over the untraced window's jobs over their frames."""
from benchmark.spans import seconds_of, window_per_frame


def read(ctx):
    return window_per_frame(ctx, seconds_of("densify"))
