"""Where the host waits on the card in one job of a cell, against the
port's sync spans.

    python3 -m benchmark.sync_audit --workload <cell> --seed <n>

run from the repository's root on a machine with a card. It makes the
cell's frames as the benchmark does, runs a warm-up job, then one job
(the first of the run's order) under torch.cuda.set_sync_debug_mode
("warn"). Each synchronizing call is put down to the innermost span of the
port's tracer open on its thread: inside a "sync.*" span it is counted
under that span; outside, its site (the innermost frame in the port's
package) is listed with the span it ran in. Warnings raised where no
Python runs (autograd's device thread inside a built-in backward) are
counted from the process's standard error. Exits 1 when any synchronizing
call in the port, or one with no Python frame, ran outside a sync span.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import tempfile
import traceback
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = os.path.join(ROOT, "isogs_slam_tpu_torch")


def _site():
    """file:line (function) of the innermost stack frame in the port, else
    in the repository (marked as outside the port)."""
    stack = traceback.extract_stack()[:-2]
    for where in (PORT, ROOT):
        for f in reversed(stack):
            if f.filename.startswith(where):
                site = (f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} "
                        f"({f.name})")
                return site if where == PORT else f"{site}, outside the port"
    return "(outside the repository)"


def audit(workload: str, seed: int) -> int:
    import torch
    from isogs_slam_tpu_torch.ops import _cuda
    from isogs_slam_tpu_torch.utils import spans
    from .jobs import FrameSource, remove, run_job
    from .run import cell_spec, make_sequences, slam_seed
    c = cell_spec(workload)
    spec, traffic = c["spec"], c["traffic"]
    device = torch.device("cuda")
    _cuda.build()
    cam = spec["camera"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                  [0, 0, 1]], np.float32)
    n_seq = int(traffic["sequences"])
    seqs, warm = make_sequences(spec, traffic, seed, device, n_seq)
    base = tempfile.mkdtemp(prefix="isogs_sync_audit")
    cfg = spec["config"]
    run_job(cfg, FrameSource(*warm[1:], K), os.path.join(base, "warm"),
            "warm", slam_seed(warm[0]), "cuda")

    inside = collections.Counter()
    outside = collections.Counter()
    shown = warnings.showwarning

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message).lower():
            return shown(message, category, filename, lineno, file, line)
        tr = spans.current()
        name = (tr.open_span() if tr is not None else None) or "(no span)"
        if name.startswith(spans.SYNC_PREFIX):
            inside[name] += 1
        else:
            outside[(_site(), name)] += 1

    start, *seq = seqs[0]
    err = tempfile.TemporaryFile(mode="w+b")
    saved = os.dup(2)
    sys.stderr.flush()
    os.dup2(err.fileno(), 2)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_job(cfg, FrameSource(*seq, K), os.path.join(base, "job"),
                        "job", slam_seed(start), "cuda")
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)
    err.seek(0)
    native = sum(1 for ln in err.read().decode(errors="replace").splitlines()
                 if "synchroniz" in ln.lower())
    remove(base)
    frames = int(traffic["frames_per_job"])
    print(f"sync_audit: {workload} start {start}, {frames} frames: "
          f"{sum(inside.values())} synchronizing calls in sync spans, "
          f"{sum(outside.values())} outside, {native} reported from "
          f"threads with no Python")
    for name, n in sorted(inside.items(), key=lambda kv: -kv[1]):
        print(f"  in  {name:28s} {n:7d} ({n / frames:.2f} a frame)")
    for (site, name), n in sorted(outside.items(), key=lambda kv: -kv[1]):
        print(f"  OUT {site} in {name}: {n}")
    in_port = sum(n for (site, _), n in outside.items()
                  if site.startswith("isogs_slam_tpu_torch"))
    return 1 if in_port or native else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    a = ap.parse_args(argv)
    return audit(a.workload, a.seed)


if __name__ == "__main__":
    sys.exit(main())
