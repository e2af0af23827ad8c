"""Tracking seconds per frame: the sum of SLAM.stats["tracking_frame_time"]
over the untraced window's jobs over their frames."""


def read(ctx):
    return ctx["tracking_s"] / ctx["frames"] if ctx["frames"] else None
