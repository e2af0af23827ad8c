"""Mapping seconds per frame: the sum of SLAM.stats["mapping_frame_time"]
over the untraced window's jobs over their frames."""


def read(ctx):
    return ctx["mapping_s"] / ctx["frames"] if ctx["frames"] else None
