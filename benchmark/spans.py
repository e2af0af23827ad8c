"""The port's spans, read back for the per-layer metrics.

The port's tracer (isogs_slam_tpu_torch/utils/spans.py) keeps a summary of
every SLAM run the process finished in `spans.FINISHED`: the run's frames,
its span totals (seconds and count by name), its frames' self time and its
count of host waits. The untraced window's jobs are the newest runs
recorded without fine spans whose frames add up to the window's; the
traced job is the newest run recorded under the profiler, whose summary
carries its tracer and the profiler that recorded it.

`attribute` joins that profile with the traced job's spans: each device
event (kernel, copy, set) goes, through its correlation id, to the CUDA
runtime call that launched it, and from there, by thread and time on the
Unix epoch, to the innermost span open on that thread. The profiler may
stamp runtime calls with thread ids of its own, which are not the native
ids the spans carry (the H100's CUDA-only profile does); a launch from a
thread with no spans, or with none open there, goes to the span opened
last among those open at that time on any thread. A span opened on
autograd's device thread has the run's innermost span as parent, so during
a backward that is the backward's own span, and else the run's innermost.
Device seconds are summed by span name, self (the innermost span) and
inclusive (every enclosing span, a name counted once per event), and the
card's idle gaps are put down to the innermost span of the run's thread
open across each gap.

With a program that has no tracer, as before it had one, every reader
returns None.
"""
from __future__ import annotations

import sys

import numpy as np

from .trace import _is_device

# spans whose own device time is not put down to a module
UNNAMED = ("slam.run", "frame")


def finished_runs():
    """The port's summaries of the runs it finished, oldest first; None
    when the port has no tracer."""
    try:
        from isogs_slam_tpu_torch.utils import spans
    except ImportError:
        return None
    return list(getattr(spans, "FINISHED", ()))


def window_runs(ctx):
    """The summaries of the untraced window's jobs, None when they cannot
    be told apart."""
    runs = finished_runs()
    frames = ctx.get("frames") or 0
    if not runs or not frames:
        return None
    out, n = [], 0
    for r in reversed(runs):
        if n >= frames:
            break
        if r.get("fine"):
            continue
        out.append(r)
        n += r["frames"]
    return out if n == frames else None


def window_per_frame(ctx, value):
    """sum(value(summary)) over the window's jobs per window frame."""
    runs = window_runs(ctx)
    if runs is None:
        return None
    return sum(value(r) for r in runs) / ctx["frames"]


def seconds_of(name):
    return lambda r: r["totals"].get(name, [0.0, 0])[0]


def _events(prof):
    res = getattr(prof, "kineto_results", None)
    if res is None:
        res = prof.profiler.kineto_results
    return res.events()


class _Innermost:
    """Innermost span open at given times on one thread: the spans' start
    and end points swept once into elementary segments."""

    def __init__(self, idx, start, end):
        marks = sorted([(start[i], 1, i) for i in idx]
                       + [(end[i], 0, i) for i in idx])
        stack, t, top = [], [], []
        for when, opens, i in marks:
            if opens:
                stack.append(i)
            elif stack and stack[-1] == i:
                stack.pop()
            elif i in stack:
                stack.remove(i)
            t.append(when)
            top.append(stack[-1] if stack else -1)
        self.t = np.asarray(t, np.int64)
        self.top = np.asarray(top, np.int64)

    def at(self, when):
        k = np.searchsorted(self.t, when, side="right") - 1
        return np.where(k >= 0, self.top[np.maximum(k, 0)], -1)


def attribute(prof, table) -> dict:
    """Device seconds of the profile `prof` (torch.profiler.profile or the
    torch.autograd.profiler.profile inside it) by span of `table`
    (Tracer.table()). Returns {"device_s", "self_s", "inclusive_s",
    "self_by_path" (self seconds by the span's path from its root),
    "kernels_by_span" (the 4 kernels with the most self time under each
    of the 6 spans with the most), "spans" (the table's length),
    "unnamed_s" (device seconds in no span or in slam.run / frame
    themselves), "launch_found" (share of device events whose launching
    call was found), "idle_s" (by innermost span across the gap),
    "longest_gaps" (the 10 longest: [seconds, path of the span open
    across, of the innermost span where the gap starts, where it ends]),
    "launch_threads" ({thread id: [device events, has spans]})}."""
    names = list(table["name"])
    n = len(names)
    parent = np.asarray(table["parent"], np.int64).reshape(n)
    start = np.asarray(table["start_ns"], np.int64).reshape(n)
    end = np.asarray(table["end_ns"], np.int64).reshape(n)
    tid = np.asarray(table["tid"], np.int64).reshape(n)
    owner = int(table["owner"])
    launch, dev = {}, []
    for ev in _events(prof):
        if _is_device(ev):
            dev.append((ev.start_ns(), ev.duration_ns(), ev.correlation_id(),
                        ev.linked_correlation_id(), ev.name()))
        elif ev.correlation_id():
            launch[ev.correlation_id()] = (ev.start_thread_id(),
                                           ev.start_ns())
    sweeps = {int(t): _Innermost(np.nonzero(tid == t)[0], start, end)
              for t in np.unique(tid)}
    own = sweeps.get(owner)

    def innermost(threads, when):
        out = np.full(len(when), -1, np.int64)
        for t in np.unique(threads):
            if int(t) in sweeps:
                sel = threads == t
                out[sel] = sweeps[int(t)].at(when[sel])
        miss = out < 0
        if miss.any() and sweeps:
            # the span opened last among those open on any thread
            cand = np.stack([sw.at(when[miss]) for sw in sweeps.values()])
            opened = np.where(cand >= 0, start[np.maximum(cand, 0)], -1)
            pick = np.argmax(opened, axis=0)
            out[miss] = cand[pick, np.arange(cand.shape[1])]
        return out

    d_start = np.asarray([d[0] for d in dev], np.int64)
    d_dur = np.asarray([d[1] for d in dev], np.int64)
    threads = np.full(len(dev), -1, np.int64)
    when = np.zeros(len(dev), np.int64)
    found = np.zeros(len(dev), bool)
    for k, (_, _, corr, linked, _) in enumerate(dev):
        hit = launch.get(corr) or launch.get(linked)
        if hit is not None:
            threads[k], when[k], found[k] = hit[0], hit[1], True
    span_of = np.full(len(dev), -1, np.int64)
    if found.any():
        span_of[found] = innermost(threads[found], when[found])

    self_ns = np.zeros(n + 1)
    np.add.at(self_ns, np.where(span_of >= 0, span_of, n), d_dur)
    incl = self_ns[:n].copy()
    for i in range(n - 1, -1, -1):
        if parent[i] >= 0:
            incl[parent[i]] += incl[i]
    self_s, incl_s, by_path, path = {}, {}, {}, []
    for i, name in enumerate(names):
        self_s[name] = self_s.get(name, 0.0) + self_ns[i] * 1e-9
        path.append(name if parent[i] < 0 else f"{path[parent[i]]}/{name}")
        by_path[path[i]] = by_path.get(path[i], 0.0) + self_ns[i] * 1e-9
        p = parent[i]
        while p >= 0 and names[p] != name:
            p = parent[p]
        if p < 0:     # not nested in a span of its own name
            incl_s[name] = incl_s.get(name, 0.0) + incl[i] * 1e-9
    unnamed = self_ns[n] * 1e-9 + sum(self_s.get(k, 0.0) for k in UNNAMED)
    # the kernels behind the spans with the most self time
    top = sorted(self_s, key=lambda k: -self_s[k])[:6]
    kern = {k: {} for k in top}
    for (_, dur, _, _, kname), i in zip(dev, span_of.tolist()):
        if i >= 0 and names[i] in kern:
            d = kern[names[i]]
            d[kname] = d.get(kname, 0.0) + dur * 1e-9
    kernels = {k: sorted(d.items(), key=lambda kv: -kv[1])[:4]
               for k, d in kern.items()}

    idle_s, longest = {}, []
    if len(dev) > 1 and own is not None:
        order = np.argsort(d_start, kind="stable")
        ds, de = d_start[order], (d_start + d_dur)[order]
        run_end = np.maximum.accumulate(de)
        new = np.ones(len(ds), bool)
        new[1:] = ds[1:] > run_end[:-1]
        g0 = np.append(run_end[np.nonzero(new)[0][1:] - 1], run_end[-1])[:-1]
        g1 = ds[new][1:]
        at = g_in = own.at(g0)
        for _ in range(64):       # up to the span open across the gap
            short = (at >= 0) & (end[np.maximum(at, 0)] < g1)
            if not short.any():
                break
            at = np.where(short, parent[np.maximum(at, 0)], at)
        gap = (g1 - g0) * 1e-9
        for i, s in zip(at.tolist(), gap.tolist()):
            key = names[i] if i >= 0 else "(no span)"
            idle_s[key] = idle_s.get(key, 0.0) + s
        ends_in = own.at(g1)
        for j in np.argsort(gap)[::-1][:10]:
            longest.append([float(gap[j])] + [
                path[i] if i >= 0 else "(no span)"
                for i in (int(at[j]), int(g_in[j]), int(ends_in[j]))])
    by_thread = {int(t): [int(np.sum(threads[found] == t)), int(t) in sweeps]
                 for t in np.unique(threads[found])}
    return {"device_s": float(d_dur.sum()) * 1e-9, "self_s": self_s,
            "inclusive_s": incl_s, "self_by_path": by_path, "spans": n,
            "kernels_by_span": kernels,
            "unnamed_s": float(unnamed),
            "launch_found": float(found.mean()) if len(dev) else 0.0,
            "launch_threads": by_thread, "idle_s": idle_s,
            "longest_gaps": longest}


def report(att: dict, frames: int, out=sys.stderr):
    """The join's tables: device time by span (self and inclusive), idle
    time by span, the longest gaps, per frame of the traced job."""
    total = att["device_s"] or 1.0
    print(f"spans: {att['spans']} spans ({att['spans'] / frames:.1f} a "
          f"frame); {att['device_s']:.4f} device s over {frames} frames; "
          f"launch found for {100 * att['launch_found']:.2f}% of device "
          f"events; {100 * att['unnamed_s'] / total:.2f}% in no named span "
          f"(none, {', '.join(UNNAMED)})", file=out)
    print("spans: launching threads (device events, has spans): "
          + ", ".join(f"{t} {n} {'yes' if has else 'no'}"
                      for t, (n, has) in att["launch_threads"].items()),
          file=out)
    print("spans: device ms/frame by span: self, inclusive", file=out)
    for name, s in sorted(att["self_s"].items(), key=lambda kv: -kv[1]):
        print(f"  {name:32s} {1000 * s / frames:10.4f} "
              f"{1000 * att['inclusive_s'].get(name, 0.0) / frames:10.4f}",
              file=out)
    print("spans: device ms/frame by span path (self, the 25 largest)",
          file=out)
    for p, s in sorted(att["self_by_path"].items(),
                       key=lambda kv: -kv[1])[:25]:
        print(f"  {1000 * s / frames:10.4f} {p}", file=out)
    print("spans: kernels under the spans with the most self time (ms/frame)",
          file=out)
    for span, ks in att["kernels_by_span"].items():
        for kname, s in ks:
            print(f"  {span:24s} {1000 * s / frames:9.4f} {kname[:110]}",
                  file=out)
    print("spans: idle ms/frame by span open across the gap", file=out)
    for name, s in sorted(att["idle_s"].items(), key=lambda kv: -kv[1]):
        print(f"  {name:32s} {1000 * s / frames:10.4f}", file=out)
    print("spans: longest idle gaps: s, open across; starts in -> ends in",
          file=out)
    for s, across, first, last in att["longest_gaps"]:
        print(f"  {s:.6f} {across}; {first} -> {last}", file=out)


_JOINED: dict = {}


def traced_join(ctx):
    """attribute() of the traced job (reported once on stderr), None when
    the run was not traced or the program kept no profile."""
    frames = ctx.get("trace_frames") or 0
    if not ctx.get("trace") or not frames:
        return None
    runs = finished_runs() or []
    run = next((r for r in reversed(runs) if r.get("tracer") is not None
                and r["frames"] == frames), None)
    if run is None:
        return None
    tr = run["tracer"]
    if id(tr) not in _JOINED:
        if tr.profiler is None:
            return None
        att = attribute(tr.profiler, tr.table())
        tr.profiler = None          # the profile's events are no longer needed
        if att["device_s"] > 0:     # a profile of the card (not of a CPU run)
            report(att, frames)
        _JOINED[id(tr)] = att if att["device_s"] > 0 else None
    return _JOINED[id(tr)]


def traced_ms_per_frame(ctx, name):
    """Inclusive device milliseconds per traced frame under spans `name`."""
    att = traced_join(ctx)
    if att is None or name not in att["inclusive_s"]:
        return None
    return 1000.0 * att["inclusive_s"][name] / ctx["trace_frames"]
