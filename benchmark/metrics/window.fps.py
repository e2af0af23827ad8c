"""Frames per second of the untraced window: all frames of all its jobs
over all its time. Reported per layer, not end to end: the host's speed
moves it by more than any bound the benchmark may set (PERF.md)."""


def read(ctx):
    if not ctx["frames"]:
        return None
    return ctx["frames"] / ctx["window_s"]
