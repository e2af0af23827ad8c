"""The port's counters (isogs_slam_tpu_torch/utils/spans.py `count`), read
back for the per-layer metrics: each finished run's summary carries them
under "counters". A program whose runs carry no counters, as before it
had them, gives None."""
from __future__ import annotations

from .spans import finished_runs, window_runs


def window_total(ctx, name):
    """The counter `name` summed over the untraced window's jobs; None
    when the jobs cannot be told apart or carry no counters."""
    runs = window_runs(ctx)
    if runs is None or any("counters" not in r for r in runs):
        return None
    return sum(r["counters"].get(name, 0) for r in runs)


def traced_total(ctx, name):
    """The counter `name` of the traced job (the run benchmark/spans.py
    joins with the profile); None when there is none or it carries no
    counters."""
    frames = ctx.get("trace_frames") or 0
    if not ctx.get("trace") or not frames:
        return None
    run = next((r for r in reversed(finished_runs() or [])
                if r.get("tracer") is not None and r["frames"] == frames),
               None)
    if run is None or "counters" not in run:
        return None
    return run["counters"].get(name, 0)
