"""Device milliseconds of kernel A (csrc/composite.cu composite_fwd_kernel)
per frame of the traced job, from the profiler's trace."""

NAME = "composite_fwd_kernel"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx["trace_frames"]:
        return None
    s = sum(v for k, v in tr["kernel_s"].items() if NAME in k)
    return 1000.0 * s / ctx["trace_frames"] if s > 0 else None
