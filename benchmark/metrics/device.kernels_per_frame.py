"""Kernel launches per frame of the traced job (the host-dispatch
bound)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["kernels"] or not ctx["trace_frames"]:
        return None
    return tr["kernels"] / ctx["trace_frames"]
