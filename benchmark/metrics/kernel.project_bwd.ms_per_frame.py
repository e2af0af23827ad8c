"""Device milliseconds of kernel P bwd (csrc/project.cu project_bwd_kernel,
its backward) per frame of the traced job,
from the profiler's trace. None where no such kernel ran."""

NAME = "project_bwd_kernel"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx["trace_frames"]:
        return None
    s = sum(v for k, v in tr["kernel_s"].items() if NAME in k)
    return 1000.0 * s / ctx["trace_frames"] if s > 0 else None
