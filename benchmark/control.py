"""Readings that set the limits of the check, at a cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        [--out FILE]

For each seed, in one process: one job of the cell's traffic on the start
`seed` mod the traffic's starts, the same job that a run takes on that
start, then the check's numbers three times: of the job against the
reference (the lower reading), of the control against the reference (the
upper reading), and of a job whose steps leave their state unchanged.
The control is the reference itself computed with TF32 on, put in the
program's place: the configuration runs float32 with TF32 off (the port
disables it on import), and TF32 is the nearest precision below. Each job's wall seconds are printed too, for
sizing frames_per_job.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from . import judge as J
from . import run as B


def readings(name: str, seed: int, device, track_iters=None) -> dict:
    from isogs_slam_tpu_torch.slam.config import inject_defaults
    from .jobs import FrameSource, final_checkpoint, remove, run_job
    c = B.cell_spec(name)
    spec, traffic = c["spec"], c["traffic"]
    # one job from the traffic's start `seed` mod its starts, so that a
    # run of seeds covers every start a run's jobs take
    n_seq = int(traffic["sequences"])
    seqs, _ = B.make_sequences(spec, traffic, seed, device, n_seq,
                               only=seed % n_seq)
    cam = spec["camera"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                  [0, 0, 1]], np.float32)
    base = os.path.join(tempfile.gettempdir(), "isogs_slam_control")
    remove(base)
    slam_seed = B.slam_seed(seqs[0][0])
    job = run_job(spec["config"], FrameSource(*seqs[0][1:], K), base, "job",
                  slam_seed, device.type)
    cfg = inject_defaults(spec["config"])
    _, col, dep, _ = seqs[0]
    with np.load(os.path.join(job["dir"], "params0.npz")) as d:
        p0 = {k: d[k] for k in d.files}
    with np.load(final_checkpoint(job["dir"])) as d:
        fin = {k: d[k] for k in d.files}
    poses = (fin["cam_unnorm_rots"][0], fin["cam_trans"][0])
    me = int(cfg["map_every"])
    first_map = me - 1 if me > 1 else 1
    prog = J.program_readings(job["dir"], p0, fin, first_map)
    t0 = time.time()
    ref = J.reference_readings(cfg, spec, (col, dep[..., 0]), p0, poses,
                               slam_seed, device)
    ref_s = time.time() - t0
    ctl = J.reference_readings(cfg, spec, (col, dep[..., 0]), p0, poses,
                               slam_seed, device, tf32_on=True)
    remove(base)
    return {"seed": seed, "job_s": job["wall_s"], "frames": job["frames"],
            "tracking_s": job["tracking_s"], "mapping_s": job["mapping_s"],
            "reference_s": ref_s,
            "sound": J.compare(prog, ref, track_iters),
            "control": J.compare(ctl, ref, track_iters),
            "unchanged": J.compare(J.unchanged_state(ref), ref, track_iters),
            "track_gaps": {who: {t: [float(np.max(np.abs(
                got["track"][t][0][i, 1:3] - r[0][i, 1:3])
                / np.abs(r[0][i, 1:3]))) for i in range(min(len(r[0]), len(
                    got["track"][t][0])))]
                for t, r in ref["track"].items()}
                for who, got in (("sound", prog), ("control", ctl))},
            "densify": [prog["densify"], ref["densify"], ctl["densify"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    from isogs_slam_tpu_torch.ops import _cuda
    _cuda.build()
    dev = torch.device("cuda")
    rows = []
    for s in [int(x) for x in a.seeds.split(",")]:
        r = readings(a.workload, s, dev, track_iters=B.cell_spec(
            a.workload)["check"]["track_iters_compared"])
        rows.append(r)
        print(json.dumps(r), file=sys.stderr, flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    for k in J.CHECKS:
        lo = max(r["sound"][k] for r in rows)
        hi = min(r["control"][k] for r in rows)
        fault = min(r["unchanged"][k] for r in rows)
        print(f"{a.workload} {k}: sound max {lo!r}, control min {hi!r}, "
              f"unchanged state min {fault!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
