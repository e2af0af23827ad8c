"""Aggregate multi-seed quality runs into per-config medians (this
package's own copy of isogs_slam_tpu/tools/seed_stats.py, which imports
nothing of JAX: the same groups and printed table).

A single run's tracked ATE moves with the seed, so configurations are
compared by their MEDIANS over seeds, not by single runs.

Usage:
  python -m isogs_slam_tpu_torch.tools.seed_stats experiments/tpu_chain_*/
Groups <name>_eval_summary.json by the prefix before a trailing _s<K>
seed tag (files without a tag form their own group) and prints
median/min/max ATE + PSNR per group.
"""
from __future__ import annotations

import glob
import json
import os
import re
import statistics
import sys

ATE = "Final Average ATE RMSE (cm)"
PSNR = "Average PSNR"
DEPTH = "Average Depth L1 (cm)"


def collect(dirs):
    groups = {}
    for d in dirs:
        for p in sorted(glob.glob(os.path.join(d, "*_eval_summary.json"))):
            name = os.path.basename(p)[: -len("_eval_summary.json")]
            group = re.sub(r"_s\d+$", "", name)
            with open(p) as f:
                s = json.load(f)
            if ATE not in s:
                continue
            groups.setdefault(group, []).append(
                (name, float(s[ATE]), float(s.get(PSNR, float("nan"))),
                 float(s.get(DEPTH, float("nan")))))
    return groups


def main(argv=None):
    dirs = (argv or sys.argv[1:]) or ["."]
    groups = collect(dirs)
    if not groups:
        print("no *_eval_summary.json found under", dirs)
        return 1
    print(f"{'config':<16} {'n':>2} {'ATE med':>8} {'min':>6} {'max':>6}"
          f" {'PSNR med':>9} {'depth med':>10}")
    for g in sorted(groups):
        rows = groups[g]
        ates = [r[1] for r in rows]
        psnrs = [r[2] for r in rows]
        depths = [r[3] for r in rows]
        print(f"{g:<16} {len(rows):>2} {statistics.median(ates):>8.3f} "
              f"{min(ates):>6.2f} {max(ates):>6.2f} "
              f"{statistics.median(psnrs):>9.2f} "
              f"{statistics.median(depths):>10.2f}")
        for name, a, p, d in rows:
            if len(rows) > 1:
                print(f"    {name:<20} ATE {a:6.3f}  PSNR {p:6.2f}  "
                      f"depth {d:6.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
