"""Device milliseconds per pose iteration: the device time launched inside
the port's "tracking" spans of the traced job (benchmark/spans.py's join
of the profile with the spans) over that job's "tracking.iters"
counter."""
from benchmark.counters import traced_total
from benchmark.spans import traced_join


def read(ctx):
    n = traced_total(ctx, "tracking.iters")
    att = traced_join(ctx) if n else None
    if att is None or "tracking" not in att["inclusive_s"]:
        return None
    return 1000.0 * att["inclusive_s"]["tracking"] / n
