"""The port's benchmark: whole SLAM jobs through `SLAM.run` on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the repository's root. One process: build (or load) the CUDA
kernels, make the cell's frames from the seed on the card, run one short
warm-up job, then run rounds of jobs, one job on each of the traffic's
starts in an order drawn from the seed, until `--seconds` have passed; the
window ends when the round under way ends, so every run does whole rounds
of the same jobs. Afterwards the end-to-end quality is read from the
jobs' outputs, the plain reference judges one job drawn from the seed
(judge.py), and the last line of standard output is one JSON object.

With `--trace 0` that object holds the cell's end-to-end metrics. With
`--trace 1` the run is the same, and one more job, the next in the run's
order of sequences, runs after the window under torch.profiler: the
per-layer metrics that come from the host's clock (tracking, mapping,
pipeline) are read from the untraced window, those that come from the
trace (kernel times, launches, idle share) from the traced job.

Everything a cell needs is found by name: BENCHMARK.json names the cell's
configuration file, benchmark/traffic/<traffic>.json its frames and motion,
benchmark/limits/<cell>.json the limits of its check, and
benchmark/metrics/<metric>.py the reader of each per-layer metric.
"""
from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

from . import host as H  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "isogs_slam_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str) -> dict:
    """The cell's entries and files, all found by name."""
    man = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = next((w for w in man["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"unknown workload {name!r}")
    conf = next(c for c in man["configs"] if c["name"] == wl["config"])
    return {"manifest": man, "workload": wl, "config": conf,
            "spec": load_json(os.path.join(ROOT, conf["file"])),
            "traffic": load_json(os.path.join(HERE, "traffic",
                                              wl["traffic"] + ".json")),
            "check": load_json(os.path.join(HERE, "limits",
                                            name + ".json"))}


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (isogs_slam_tpu_torch is not isogs_slam_tpu)."""
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


def seed_words(seed: int, *tags) -> list:
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32] + [int(t) for t in tags]


def derived_seed(seed: int, *tags, bits: int = 31) -> int:
    ss = np.random.SeedSequence(seed_words(seed, *tags))
    return int(ss.generate_state(1, np.uint64)[0]) % (1 << bits)


def layer_readers(names) -> dict:
    from . import plugins
    return {n: plugins.load("metrics", n).read for n in names}


def cell_metrics(man: dict, wl_name: str, trace: bool) -> list:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in man[kind]
            if "workloads" not in m or wl_name in m["workloads"]]


def make_sequences(spec, traffic, seed, device, n_seq, only=None):
    """The run's job sequences, cast on the card and handed to the host:
    [(start, colour, depth [n, H, W, 1], c2w)], one for each of the
    traffic's n_seq fixed starts in an order drawn from the seed, and a
    warm-up sequence from a start of its own (start n_seq). A start's
    frames (textures, sensor noise) are the same in every run, so every
    seed does the same work in another order. `only`: just the sequence
    of that start (and the warm-up's)."""
    import torch
    from .scene import make_frames
    cam = spec["camera"]
    camera = {"width": cam["image_width"], "height": cam["image_height"],
              "fx": cam["fx"], "fy": cam["fy"], "cx": cam["cx"],
              "cy": cam["cy"]}
    order = np.random.RandomState(derived_seed(seed, 6)).permutation(n_seq)
    if only is not None:
        order = [only]
    out = []
    for j, start in enumerate(list(order) + [n_seq]):
        tr = dict(traffic)
        if j == len(order):
            tr["frames_per_job"] = traffic["warmup_frames"]
        col, dep, c2w = make_frames(
            camera, tr, derived_seed(0, 1, int(start), bits=63), int(start),
            device)
        out.append((int(start), col.cpu().numpy(),
                    dep[..., None].cpu().numpy(), c2w))
        del col, dep
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out[:-1], out[-1]


def slam_seed(start: int) -> int:
    """The configuration's seed of a job on `start` (the SLAM object's
    random streams), fixed per start as the frames are."""
    return derived_seed(0, 2, start)


def quality(jobs, seqs, spec, device):
    """ate_cm over every job's frames, psnr_db over every job's keyframes
    (the final map, at the job's own estimated keyframe poses). Each is
    the mean over the traffic's starts of that start's mean over its
    jobs, so that a window that takes one start once more than the others
    weighs it no more: a run's quality is that of the traffic's fixed
    sequences, whatever order the seed gives them."""
    import torch
    from .reference import quality as Q
    from .reference import slam as S
    from .judge import cam_of
    from .jobs import final_checkpoint
    cam = cam_of(spec)
    errs, psnrs = {}, {}
    for job in jobs:
        if job.get("error"):
            continue
        start, col, dep, c2w = seqs[job["seq"]]
        with np.load(final_checkpoint(job["dir"])) as d:
            fin = {k: d[k] for k in d.files}
        rots, trans = fin["cam_unnorm_rots"][0], fin["cam_trans"][0]
        n = len(c2w)
        gt = [np.linalg.inv(c2w[i]) for i in range(n)]
        est = [Q.w2c_from(rots[:, i], trans[:, i]) for i in range(n)]
        errs.setdefault(start, []).extend(Q.ate_errors(gt, est).tolist())
        m = S.map_from_npz(fin, device)
        alive = torch.ones(m.means.shape[0], dtype=torch.bool, device=device)
        for k in np.asarray(fin["keyframe_time_indices"]).tolist():
            im = torch.as_tensor(col[k], device=device).permute(2, 0, 1) / 255
            psnrs.setdefault(start, []).append(
                Q.psnr(m, alive, rots[:, k], trans[:, k], im.contiguous(),
                       cam))
        del m, fin

    def over_starts(by_start):
        if not by_start:
            return float("nan")
        return float(np.mean([np.mean(v) for v in by_start.values()]))
    return 100.0 * over_starts(errs), over_starts(psnrs)


def judge_job(job, seqs, spec, cfg, device, check):
    from . import judge as J
    from .jobs import final_checkpoint
    _, col, dep, _ = seqs[job["seq"]]
    with np.load(os.path.join(job["dir"], "params0.npz")) as d:
        p0 = {k: d[k] for k in d.files}
    with np.load(final_checkpoint(job["dir"])) as d:
        fin = {k: d[k] for k in d.files}
    map_every = int(cfg["map_every"])
    first_map = map_every - 1 if map_every > 1 else 1
    prog = J.program_readings(job["dir"], p0, fin, first_map)
    ref = J.reference_readings(
        cfg, spec, (col, dep[..., 0]), p0,
        (fin["cam_unnorm_rots"][0], fin["cam_trans"][0]), job["slam_seed"],
        device)
    nums = J.compare(prog, ref, check["track_iters_compared"])
    return nums, J.verdict(nums, check["limits"])


def host_summary(first, start, end, recs, card0, card1, frames, window_s,
                 setup_s, threads) -> dict:
    """The run's host record: where the process could run and did, the
    card's node, and the jobs' host times (medians over the window's
    jobs) beside the window's frames per second."""
    node = H.card_node((card0 or {}).get("pci.bus_id"))
    out = {"fps": frames / window_s if window_s else None,
           "setup_s": setup_s, "cpu_count": first["cpu_count"],
           "affinity": H.cpulist_text(first["affinity"]),
           "torch_threads": threads, "card_node": node,
           "node_cpus": H.cpulist_text(H.node_cpus(node)),
           "card_setup": card0, "card_end": card1,
           "loadavg": end["loadavg"], "mhz": end["mhz"],
           "read_ms": max([s["read_ms"] for s in (first, start)]
                          + [r["read_ms"] for r in recs]),
           "setup": H.between(first, start), "window": H.between(start, end)}
    for key in ("cpu_s", "run_s", "wait_s", "nvcsw"):
        vals = [r["main"][key] for r in recs if "main" in r]
        if vals:
            out["main_" + key + "_job"] = float(np.median(vals))
    if recs:
        out["others_cpu_s_job"] = float(np.median(
            [r["others"]["cpu_s"] for r in recs]))
    out["main_cpus"] = sorted({c for r in recs for c in
                               r.get("main", {}).get("cpus", [])})
    return out


def run(name: str, seed: int, seconds: float, trace: bool, device,
        shrink: dict | None = None, host0: dict | None = None,
        card: H.CardQuery | None = None) -> dict:
    """One run of cell `name`; returns the result object. `shrink` (tests
    only) replaces camera and traffic entries to run at a toy size.
    `host0`: the host's snapshot taken before torch was imported; `card`:
    nvidia-smi's reading asked then."""
    first = host0 or H.snapshot()
    import torch
    from isogs_slam_tpu_torch.slam.config import inject_defaults
    from .jobs import FrameSource, remove, run_job
    c = cell_spec(name)
    wl, spec, traffic = c["workload"], c["spec"], c["traffic"]
    if shrink:
        spec = dict(spec, camera=dict(spec["camera"], **shrink["camera"]))
        traffic = dict(traffic, **shrink["traffic"])
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    if cuda:
        from isogs_slam_tpu_torch.ops import _cuda
        _cuda.build()
    base = os.path.join(tempfile.gettempdir(), "isogs_slam_bench")
    remove(base)
    os.makedirs(base)
    cfg = spec["config"]
    K = np.array([[spec["camera"]["fx"], 0, spec["camera"]["cx"]],
                  [0, spec["camera"]["fy"], spec["camera"]["cy"]],
                  [0, 0, 1]], np.float32)
    n_seq = int(traffic["sequences"])
    seqs, warm = make_sequences(spec, traffic, seed, device, n_seq)
    run_job(cfg, FrameSource(*warm[1:], K), os.path.join(base, "warmup"),
            "warmup", slam_seed(warm[0]), device.type)
    remove(os.path.join(base, "warmup"))
    gc.collect()

    host_recs, host_snaps = [], []   # per job; window start, then each end

    def one_job(j):
        job = {"seq": j % n_seq,
               "slam_seed": slam_seed(seqs[j % n_seq][0])}
        try:
            job.update(run_job(cfg, FrameSource(*seqs[j % n_seq][1:], K),
                               os.path.join(base, f"job{j}"), f"job{j}",
                               job["slam_seed"], device.type))
        except Exception:
            traceback.print_exc()
            job["error"] = True
        gc.collect()
        snap = H.snapshot()
        rec = H.between(host_snaps[-1], snap)
        host_snaps.append(snap)
        host_recs.append(rec)
        if "wall_s" in job:
            print(f"benchmark: job {j} start {seqs[j % n_seq][0]}: "
                  f"{job['wall_s']:.3f} s", file=sys.stderr)
        print(H.line(f"job {j}", rec), file=sys.stderr)
        return job

    card0 = card.result() if card else None
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    host_snaps.append(H.snapshot())
    t0 = time.time()
    setup_s = t0 - T_PROCESS
    jobs = []
    # whole rounds over the starts until `seconds` have passed: every run
    # times the same jobs, whatever order its seed gives them
    while True:
        jobs.append(one_job(len(jobs)))
        if time.time() - t0 >= seconds and len(jobs) % n_seq == 0:
            break
    sync()
    window_s = time.time() - t0
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    window_recs, window_end = list(host_recs), host_snaps[-1]
    card1 = H.CardQuery().result() if card else None
    ok_jobs = [jb for jb in jobs if not jb.get("error")]
    frames = sum(jb["frames"] for jb in ok_jobs)
    ctx = {"frames": frames, "window_s": window_s, "trace": None,
           "trace_frames": 0,
           "tracking_s": sum(jb["tracking_s"] for jb in ok_jobs),
           "mapping_s": sum(jb["mapping_s"] for jb in ok_jobs)}
    attempted, failed = len(jobs), len(jobs) - len(ok_jobs)
    if trace:
        # one more job, the next in the run's order, under the profiler:
        # device activity and the CUDA runtime calls that come with it (the
        # host's operator events would slow the job further)
        from torch.profiler import ProfilerActivity, profile
        from .trace import summarize
        prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                   else ProfilerActivity.CPU])
        t1 = time.time()
        with prof:
            tjob = one_job(len(jobs))
            sync()
        traced_s = time.time() - t1
        attempted += 1
        if tjob.get("error"):
            failed += 1
        else:
            ctx["trace"] = summarize(prof, traced_s)
            ctx["trace_frames"] = tjob["frames"]
            remove(tjob["dir"])
            print(f"benchmark: traced job {traced_s:.3f} s for "
                  f"{tjob['frames']} frames, {traced_s / tjob['frames']:.4f}"
                  f" s/frame against {window_s / max(frames, 1):.4f} "
                  f"untraced", file=sys.stderr)
        del prof
    summary = ctx["trace"]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ate_cm, psnr_db = quality(ok_jobs, seqs, spec, device)
    nums, ok = {}, False
    if ok_jobs:
        rs = np.random.RandomState(derived_seed(seed, 4))
        pick = ok_jobs[rs.randint(len(ok_jobs))]
        try:
            nums, ok = judge_job(pick, seqs, spec, inject_defaults(cfg),
                                 device, c["check"])
        except Exception:
            traceback.print_exc()
            ok = False
    remove(base)
    found = forbidden_modules(list(sys.modules))
    if found:
        raise RuntimeError(f"the run loaded {found}")
    correct = bool(ok and failed == 0 and np.isfinite(ate_cm)
                   and np.isfinite(psnr_db))

    values = {"ate_cm": ate_cm, "psnr_db": psnr_db,
              "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    metrics = {}
    chosen = cell_metrics(c["manifest"], wl["name"], trace)
    readers = layer_readers([m["name"] for m in chosen]) if trace else {}
    for m in chosen:
        v = readers[m["name"]](ctx) if trace else values[m["name"]]
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else device.type),
                   "count": int(wl["chips"]), "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = float(summary["busy_s"])
        device_info["window_s"] = float(summary["window_s"])
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = {k: {"value": float(nums.get(k, float("nan"))),
                         "limit": float(v)}
                     for k, v in c["check"]["limits"].items()}
    print(H.line("run", host_summary(
        first, host_snaps[0], window_end, window_recs, card0, card1, frames,
        window_s, setup_s, torch.get_num_threads())), file=sys.stderr)
    print(f"benchmark: {wl['name']} seed {seed}: {len(jobs)} jobs, "
          f"{frames} frames in {window_s:.3f} s, setup {setup_s:.3f} s, "
          f"{time.time() - T_PROCESS:.3f} s in all", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    host0 = H.snapshot()
    chips = int(cell_spec(a.workload)["workload"]["chips"])
    # a library the port uses must not bring JAX in by itself
    os.environ.setdefault("USE_FLAX", "0")
    card = H.CardQuery()         # answers while torch is imported
    try:
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            print(f"benchmark: needs {chips} CUDA device(s), found {have}",
                  file=sys.stderr)
            return 3
        out = run(a.workload, a.seed, a.seconds, bool(a.trace),
                  torch.device("cuda"), host0=host0, card=card)
    except RuntimeError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    finally:
        card.close()
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
