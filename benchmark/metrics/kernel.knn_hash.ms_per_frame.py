"""Device milliseconds of kernel K (csrc/knn.cu knn_hash_kernel, the iso
term's hash-grid K-nearest query) per frame of the traced job, from the
profiler's trace. None where no such kernel ran."""

NAMES = ("knn_hash_kernel",)


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx["trace_frames"]:
        return None
    s = sum(v for k, v in tr["kernel_s"].items()
            if any(n in k for n in NAMES))
    return 1000.0 * s / ctx["trace_frames"] if s > 0 else None
