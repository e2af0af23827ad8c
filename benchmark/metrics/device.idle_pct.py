"""Share of the traced job's wall time in which no operation ran on the
card. The profiler slows the host, so this reads higher than an untraced
job would."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
