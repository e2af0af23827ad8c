"""The traced run's reduction: torch.profiler (CUDA activity) over the
traced job that follows the window, read once it ends.

Device activity is every event on the card (kernels, copies, sets); busy
seconds are the length of their union. A kernel is a device event whose
name is not a copy or a set. Idle gaps are the spaces between busy
intervals, each named by the innermost host event (a CUDA runtime call)
running when it opened.
"""
from __future__ import annotations

import numpy as np


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type()).upper()


def summarize(prof, window_s: float) -> dict:
    events = prof.profiler.kineto_results.events()
    dev_s, dev_e, dev_n = [], [], []
    cpu_s, cpu_e, cpu_n = [], [], []
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if _is_device(ev):
            dev_s.append(s), dev_e.append(e), dev_n.append(ev.name())
        else:
            cpu_s.append(s), cpu_e.append(e), cpu_n.append(ev.name())
    if not dev_s:
        return {"busy_s": 0.0, "window_s": window_s, "kernels": 0,
                "kernel_s": {}, "device_ops": [], "idle_gaps": []}
    ds = np.asarray(dev_s, np.int64)
    de = np.asarray(dev_e, np.int64)
    order = np.argsort(ds, kind="stable")
    ds, de = ds[order], de[order]
    names = [dev_n[i] for i in order]
    # union of the device intervals
    run_end = np.maximum.accumulate(de)
    new = np.ones(len(ds), bool)
    new[1:] = ds[1:] > run_end[:-1]
    starts = ds[new]
    ends = np.append(run_end[np.nonzero(new)[0][1:] - 1], run_end[-1])
    busy_ns = int(np.sum(ends - starts))
    kernel_s: dict = {}
    n_kernels = 0
    for n, s, e in zip(names, ds, de):
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) * 1e-9
        low = n.lower()
        if not (low.startswith("memcpy") or low.startswith("memset")):
            n_kernels += 1
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    if len(starts) > 1:
        g0, g1 = ends[:-1], starts[1:]
        longest = np.argsort(g1 - g0)[::-1][:10]
        cs = np.asarray(cpu_s, np.int64)
        ce = np.asarray(cpu_e, np.int64)
        for i in longest:
            at = g0[i]
            cover = np.nonzero((cs <= at) & (ce >= at))[0]
            label = (cpu_n[cover[np.argmax(cs[cover])]] if len(cover)
                     else "(no host op)")
            gaps.append([label, float((g1[i] - g0[i]) * 1e-9)])
    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "kernels": n_kernels, "kernel_s": kernel_s,
            "device_ops": [[n, float(s)] for n, s in top],
            "idle_gaps": gaps}
