"""Device milliseconds per frame of the traced job launched inside the
port's "mapping.backward" spans (the mapping loss's backward: kernel B,
the expansion scatter and kernel C, the other terms' gradients), with the
spans nested in them: benchmark/spans.py's join of the profile with the
program's spans."""
from benchmark.spans import traced_ms_per_frame


def read(ctx):
    return traced_ms_per_frame(ctx, "mapping.backward")
