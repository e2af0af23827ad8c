"""Device milliseconds per frame of the traced job launched inside the
port's "mapping.adam" spans (the Adam step over every Gaussian parameter,
core/optim.py): benchmark/spans.py's join of the profile with the
program's spans."""
from benchmark.spans import traced_ms_per_frame


def read(ctx):
    return traced_ms_per_frame(ctx, "mapping.adam")
