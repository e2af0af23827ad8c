"""The frame loop's own glue per frame: the port's "frame" spans less
their stage children (upload, init, tracking, densify, mapping, compact,
keyframe, progress, checkpoint), summed over the untraced window's jobs
over their frames: measured inside the program, where
pipeline.other_s_per_frame is what the window leaves over."""
from benchmark.spans import window_per_frame


def read(ctx):
    return window_per_frame(ctx, lambda r: r["frame_self_s"])
