"""Host waits on the card per frame: the count of the port's "sync.*"
spans (one around each place the host blocks on the card: a read back, a
blocking copy, a synchronize) over the untraced window's jobs over their
frames."""
from benchmark.spans import window_per_frame


def read(ctx):
    return window_per_frame(ctx, lambda r: r["syncs"])
