"""Host milliseconds per pose iteration: the port's "tracking" spans
(binning, gather, the Adam loop and its waits) over the untraced window's
jobs, over their "tracking.iters" counter."""
from benchmark.counters import window_total
from benchmark.spans import seconds_of, window_runs


def read(ctx):
    n = window_total(ctx, "tracking.iters")
    if not n:
        return None
    return 1000.0 * sum(seconds_of("tracking")(r)
                        for r in window_runs(ctx)) / n
