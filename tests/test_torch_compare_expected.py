"""The port's own copy of tools/compare_expected.py against the JAX one:
the same rows, exit codes and printed table on the same summaries."""
import json
import os

import pytest

from isogs_slam_tpu.tools import compare_expected as jce
from isogs_slam_tpu_torch.tools import compare_expected as ce

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "configs", "replica", "expected_metrics.json")


def _summary(ate, psnr, l1, **extra):
    return {"Final Average ATE RMSE (cm)": ate, "Average PSNR": psnr,
            "Average Depth L1 (cm)": l1, **extra}


def test_tables_match_reference():
    assert ce.SUMMARY_KEYS == jce.SUMMARY_KEYS
    assert ce.HIGHER_BETTER == jce.HIGHER_BETTER
    for metric in ("ate_rmse_cm", "psnr", "ms_ssim", "depth_l1_cm"):
        for got in (0.0, 0.3, 31.9, 40.0):
            for tol in ({}, {"abs": 0.05}, {"rel": 0.1, "abs": 0.05}):
                assert ce.within(metric, got, 0.28, tol) == \
                    jce.within(metric, got, 0.28, tol)
    with open(SPEC) as f:
        spec = json.load(f)
    for s in (_summary(0.29, 32.1, 0.52), _summary(1.0, 25.0, 0.52),
              {"Average PSNR": 33.0}):
        assert ce.compare_scene("room0", s, spec["scenes"]["room0"],
                                spec["tolerances"]) == jce.compare_scene(
            "room0", s, spec["scenes"]["room0"], spec["tolerances"])


@pytest.mark.parametrize("case", ["pass", "fail", "missing", "inferred",
                                  "unknown_scene", "unreadable", "usage"])
def test_cli_matches_reference(tmp_path, capsys, case):
    """main() gives the JAX tool's exit code and text on each case: every
    metric in band (0), out of band (1), absent from the summary (1), the
    scene taken from the path (0), a scene with no recorded numbers (0),
    an unreadable summary (2: nothing compared), no summary at all (2)."""
    run = tmp_path / "room0_0" / "eval"
    run.mkdir(parents=True)
    path = run / "eval_summary.json"
    summary = {"pass": _summary(0.29, 32.1, 0.52),
               "fail": _summary(1.0, 25.0, 0.52),
               "missing": {"Average PSNR": 33.0}}.get(
        case, _summary(0.2, 33.0, 0.4))
    path.write_text(json.dumps(summary))
    args = {"inferred": [SPEC, str(path)],
            "unknown_scene": [SPEC, f"office9={path}"],
            "unreadable": [SPEC, f"room0={tmp_path / 'absent.json'}"],
            "usage": [SPEC]}.get(case, [SPEC, f"room0={path}"])
    out = []
    for mod in (jce, ce):
        rc = mod.main(list(args))
        out.append((rc, capsys.readouterr().out))
    want_rc = {"pass": 0, "fail": 1, "missing": 1, "inferred": 0,
               "unknown_scene": 0, "unreadable": 2, "usage": 2}[case]
    assert out[0][0] == out[1][0] == want_rc
    if case == "usage":        # the usage text is each module's docstring
        assert "compare_expected" in out[1][1]
    else:
        assert out[0][1] == out[1][1]


def test_seed_stats_matches_reference(tmp_path, capsys):
    """The port's copy of tools/seed_stats.py groups the same summaries
    (a trailing _s<K> seed tag) and prints the JAX tool's table."""
    from isogs_slam_tpu.tools import seed_stats as jss
    from isogs_slam_tpu_torch.tools import seed_stats as ss
    runs = (("room0_s0", 0.05, 40.1), ("room0_s1", 0.07, 39.8),
            ("room0_s2", 0.06, 40.4), ("fast", 0.2, 38.0))
    for name, ate, psnr in runs:
        (tmp_path / f"{name}_eval_summary.json").write_text(json.dumps(
            {"Final Average ATE RMSE (cm)": ate, "Average PSNR": psnr,
             "Average Depth L1 (cm)": 0.1}))
    (tmp_path / "other_eval_summary.json").write_text("{}")
    assert ss.collect([str(tmp_path)]) == jss.collect([str(tmp_path)])
    out = []
    for mod in (jss, ss):
        assert mod.main([str(tmp_path)]) == 0
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and "room0" in out[1]
    assert ss.main([str(tmp_path / "none")]) == 1
