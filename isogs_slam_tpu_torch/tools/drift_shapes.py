"""Tabulate drift shapes (ATE-so-far vs frame) from committed
`*_progress.txt` artifacts (this package's own copy of
isogs_slam_tpu/tools/drift_shapes.py, which imports nothing of JAX: the
same table, byte for byte).

The round-5 adjudications turn on drift SHAPE, not endpoint ATE
(NOTES: fastlegal8 converges slower early but drifts flatter, crossing
below the exact control by ~frame 60). The [progress] lines carry the
evidence; this tool aligns them into one table per run group so a
reader can see the shapes side by side without grepping artifacts.

Usage:
  python -m isogs_slam_tpu_torch.tools.drift_shapes artifacts/r5s* \
      [--names long100sn_s0,long100fs8_s0,...] [--every 10]
"""
from __future__ import annotations

import argparse
import glob
import os
import re

LINE = re.compile(
    r"\[progress\] frame (\d+):.*ATE ([0-9.]+) cm")


def collect(dirs):
    series = {}
    for d in dirs:
        for p in sorted(glob.glob(os.path.join(d, "*_progress.txt"))):
            name = os.path.basename(p)[: -len("_progress.txt")]
            pts = []
            with open(p) as f:
                for line in f:
                    m = LINE.search(line)
                    if m:
                        pts.append((int(m.group(1)), float(m.group(2))))
            if pts:
                series[name] = dict(pts)
    return series


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--names", default=None,
                    help="comma list; default = every *_progress.txt found")
    ap.add_argument("--every", type=int, default=10,
                    help="row stride in frames (default 10)")
    args = ap.parse_args(argv)
    series = collect(args.dirs)
    if args.names:
        names = [n for n in args.names.split(",") if n in series]
        missing = [n for n in args.names.split(",")
                   if n and n not in series]
        if missing:
            print(f"(missing: {missing})")
    else:
        names = sorted(series)
    if not names:
        print("no progress series found under", args.dirs)
        return 1
    frames = sorted({f for n in names for f in series[n]})
    frames = [f for f in frames
              if f % args.every in (args.every - 1, 0) or f == frames[-1]]
    print("ATE-so-far (cm) by frame:")
    print("| frame | " + " | ".join(names) + " |")
    print("|---|" + "---|" * len(names))
    last = None
    for f in frames:
        if f == last:
            continue
        last = f
        cells = [f"{series[n][f]:.2f}" if f in series[n] else ""
                 for n in names]
        print(f"| {f} | " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
