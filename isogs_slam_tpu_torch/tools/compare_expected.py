"""Compare a run's eval summary against recorded reference numbers
(this package's own copy of isogs_slam_tpu/tools/compare_expected.py, which
imports nothing of JAX: the same rows, text and exit codes).

The reference never shipped a machine-checkable quality contract — its
baseline numbers live in dev-log prose (python_ordinary/日志/
Dec16_first_setup_baseline.md:60,71). This tool makes the comparison
mechanical: given an expected-metrics JSON (configs/replica/
expected_metrics.json) and one or more eval_summary.json files produced by
eval/eval_helpers.eval_sequence, it prints per-metric deltas and exits
non-zero when any metric falls outside its tolerance band.

Usage:
  python -m isogs_slam_tpu_torch.tools.compare_expected \
      configs/replica/expected_metrics.json \
      room0=experiments/Replica/room0_0/eval/eval_summary.json [...]

Scene args may also be bare paths; the scene is then inferred from the
path component matching a key in the expected file's "scenes" map.
"""
from __future__ import annotations

import json
import sys

# eval_summary.json key per expected-metric key (eval/eval_helpers.py)
SUMMARY_KEYS = {
    "ate_rmse_cm": "Final Average ATE RMSE (cm)",
    "psnr": "Average PSNR",
    "depth_l1_cm": "Average Depth L1 (cm)",
    "ms_ssim": "Average MS-SSIM",
    "lpips": "Average LPIPS",
}
# metrics where larger is better (tolerance is a one-sided lower band)
HIGHER_BETTER = {"psnr", "ms_ssim"}


def within(metric: str, got: float, want: float, tol: dict):
    """(ok, band) for one metric. Band = max(abs, rel*want); PSNR-like
    metrics only fail when BELOW want - band (beating the reference is
    never a failure), error-like ones only when ABOVE want + band."""
    band = max(float(tol.get("abs", 0.0)),
               float(tol.get("rel", 0.0)) * abs(want))
    if metric in HIGHER_BETTER:
        return got >= want - band, band
    return got <= want + band, band


def compare_scene(scene: str, summary: dict, expected: dict,
                  tolerances: dict):
    """Returns (rows, n_fail): rows of (metric, got, want, band, status)."""
    rows, n_fail = [], 0
    for metric, want in expected.items():
        skey = SUMMARY_KEYS.get(metric, metric)
        if skey not in summary:
            rows.append((metric, None, want, None, "MISSING"))
            n_fail += 1
            continue
        got = float(summary[skey])
        ok, band = within(metric, got, float(want),
                          tolerances.get(metric, {}))
        if not ok:
            n_fail += 1
        rows.append((metric, got, float(want), band,
                     "ok" if ok else "FAIL"))
    return rows, n_fail


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(__doc__)
        return 2
    with open(argv[0]) as f:
        spec = json.load(f)
    scenes = spec.get("scenes", {})
    tolerances = spec.get("tolerances", {})

    total_fail = 0
    compared = 0
    skipped = 0
    for arg in argv[1:]:
        if "=" in arg:
            scene, path = arg.split("=", 1)
        else:
            path = arg
            scene = next((s for s in scenes if s in path), None)
            if scene is None:
                print(f"[skip] {path}: no scene key of {list(scenes)} "
                      "in path; pass scene=path explicitly")
                skipped += 1
                continue
        if scene not in scenes:
            print(f"[skip] {scene}: no expected numbers recorded")
            skipped += 1
            continue
        try:
            with open(path) as f:
                summary = json.load(f)
        except OSError as e:
            print(f"[skip] {scene}: {e}")
            continue
        rows, n_fail = compare_scene(scene, summary, scenes[scene],
                                     tolerances)
        compared += 1
        total_fail += n_fail
        print(f"== {scene} ({path})")
        for metric, got, want, band, status in rows:
            if got is None:
                print(f"  {metric:14s} expected {want:<8} -- absent "
                      f"from summary [{status}]")
            else:
                print(f"  {metric:14s} got {got:8.3f}  expected "
                      f"{want:8.3f} +/- {band:.3f}  [{status}]")
    if compared == 0:
        # distinguish "nothing recorded for these scenes" (a skip, not a
        # failure — batch drivers may eval scenes without expected
        # numbers) from argv misuse (no summaries given at all)
        print("no scenes compared")
        return 0 if skipped else 2
    print(("PASS" if total_fail == 0 else f"FAIL ({total_fail} metric(s)"
           " outside tolerance)"))
    return 0 if total_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
