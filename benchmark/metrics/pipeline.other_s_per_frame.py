"""Pipeline self time per frame: the untraced window less the summed
tracking and mapping stage times the jobs' SLAM.stats recorded (job
start, first-frame init, upload, densification, keyframes, checkpoints,
eval)."""


def read(ctx):
    if not ctx["frames"]:
        return None
    return ((ctx["window_s"] - ctx["tracking_s"] - ctx["mapping_s"])
            / ctx["frames"])
