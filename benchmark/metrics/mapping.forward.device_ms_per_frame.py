"""Device milliseconds per frame of the traced job launched inside the
port's "mapping.forward" spans (the mapping loss's forward: projection,
compositing with kernel A, the photometric, flat and iso terms), with the
spans nested in them: benchmark/spans.py's join of the profile with the
program's spans."""
from benchmark.spans import traced_ms_per_frame


def read(ctx):
    return traced_ms_per_frame(ctx, "mapping.forward")
