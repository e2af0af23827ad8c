"""Device milliseconds per frame of the traced job launched inside the
port's "loss.outlier_mask" spans: the tracking loss's median of the depth
errors (a full sort of the frame's pixels) and the outlier mask it sets,
once every pose iteration where outlier depth is ignored."""
from benchmark.spans import traced_ms_per_frame


def read(ctx):
    return traced_ms_per_frame(ctx, "loss.outlier_mask")
