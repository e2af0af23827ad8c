"""Apply the variance-aware decision rule to multi-seed quality groups
(this package's own copy of isogs_slam_tpu/tools/contracts.py, on its own
tools/seed_stats.py: the same verdicts and printed table, byte for byte).

NOTES.md round-4 ("The variance-aware quality decision rule"): compare
per-config MEDIANS over >= 3 seeds against a named control group; an
effect is REAL iff |delta of medians| exceeds 2x the control group's
own seed range (the measured noise scale of the regime). Verdicts
within 2x noise are PROVISIONAL; the 100-frame drift-shape run is the
tiebreaker.

Usage:
  python -m isogs_slam_tpu_torch.tools.contracts --control silnorm \
      artifacts/r4s2 artifacts/r4s1
prints, for every other group, the ATE/PSNR deltas vs the control and a
verdict line:
  PASS        — no real degradation (|dATE| <= max(2x noise, rel_tol))
  FAIL        — real degradation beyond the contract margin
  PROVISIONAL — effect within 2x noise of the decidability edge
  IMPROVES    — really better than control
The default contract margin is 10% relative ATE (--rel-tol 0.10), the
round-3 fast-mode contract.

The long-run tiebreaker (--tiebreak control_long:candidate_long):
30-frame x 3-seed margins for the fast-mode contracts sit exactly at
the decidability edge (margin == 2x noise), so the rule's designated
tiebreaker is the 100-frame drift-shape pair — drift is super-linear
from ~frame 15 (NOTES r3s3 mapsub1f shape), so length separates
configurations that seeds cannot. With --tiebreak, rows named in
--tiebreak-covers (default: the fastlegal candidate and its component
levers, which are all sub-configurations of the candidate long run —
a component that caused real drift would have to show in the
combination at length) get their PROVISIONAL verdicts upgraded:
  PASS  if the long-run ATE delta <= max(rel_tol * control_long,
        2x the 30-frame noise) and the long-run PSNR drop <= psnr_tol
  FAIL  if it exceeds that margin
Upgraded rows are tagged "(long100)".
"""
from __future__ import annotations

import argparse
import statistics

from .seed_stats import ATE, PSNR, collect

TIEBREAK_COVERS_DEFAULT = "fastlegal,tsub4sn,kcapsn,msub4sn"


def adjudicate(groups, control: str, rel_tol: float = 0.10,
               psnr_tol: float = 0.5):
    """Returns (noise, rows): noise = control 3-seed ATE range; rows =
    [(group, n, d_ate, d_psnr, verdict)] for every non-control group."""
    if control not in groups:
        raise SystemExit(f"control group {control!r} not found; have: "
                         f"{sorted(groups)}")
    ctrl = groups[control]
    c_ates = [r[1] for r in ctrl]
    c_psnr = [r[2] for r in ctrl]
    c_med = statistics.median(c_ates)
    noise = max(c_ates) - min(c_ates)
    margin = max(2.0 * noise, rel_tol * c_med)
    rows = []
    for g in sorted(groups):
        if g == control:
            continue
        rs = groups[g]
        ates = [r[1] for r in rs]
        psnrs = [r[2] for r in rs]
        d_ate = statistics.median(ates) - c_med
        d_psnr = statistics.median(psnrs) - statistics.median(c_psnr)
        if d_ate <= -2.0 * noise and len(rs) >= 2:
            verdict = "IMPROVES"
        elif d_ate <= margin and d_psnr >= -psnr_tol:
            # inside the contract; decidable only when the margin
            # clears the noise scale
            verdict = "PASS" if margin > 2.0 * noise else "PROVISIONAL"
        elif d_ate <= margin + 2.0 * noise:
            verdict = "PROVISIONAL"
        else:
            verdict = "FAIL"
        if len(rs) < 3 and verdict in ("PASS", "FAIL"):
            verdict += " (n<3)"
        rows.append((g, len(rs), d_ate, d_psnr, verdict))
    return c_med, noise, margin, rows


def apply_tiebreak(groups, rows, noise, tiebreak: str, covers: str,
                   rel_tol: float = 0.10, psnr_tol: float = 0.5):
    """Upgrade PROVISIONAL verdicts in `rows` from the 100-frame
    drift-shape pair. Returns (new_rows, summary_line) — summary_line is
    None (with rows unchanged) when either long group is missing."""
    ctrl_name, _, cand_name = tiebreak.partition(":")
    if ctrl_name not in groups or cand_name not in groups:
        missing = [n for n in (ctrl_name, cand_name) if n not in groups]
        return rows, None, f"tiebreak groups missing: {missing}"
    cL = groups[ctrl_name]
    fL = groups[cand_name]
    cL_ate = statistics.median([r[1] for r in cL])
    fL_ate = statistics.median([r[1] for r in fL])
    cL_psnr = statistics.median([r[2] for r in cL])
    fL_psnr = statistics.median([r[2] for r in fL])
    d_ate = fL_ate - cL_ate
    d_psnr = fL_psnr - cL_psnr
    margin_l = max(rel_tol * cL_ate, 2.0 * noise)
    ok = d_ate <= margin_l and d_psnr >= -psnr_tol
    long_verdict = "PASS" if ok else "FAIL"
    covered = {c.strip() for c in covers.split(",") if c.strip()}
    new_rows = []
    for g, n, da, dp, verdict in rows:
        if g in covered and verdict.startswith("PROVISIONAL"):
            verdict = f"{long_verdict} (long100)"
        elif g in covered and verdict.startswith("FAIL") \
                and long_verdict == "PASS":
            # the two protocols disagree: a 30-frame FAIL the tiebreaker
            # cannot upgrade (it only breaks ties), but hiding the
            # long-run evidence would be dishonest in the other
            # direction — label the conflict, claim nothing
            verdict = "CONFLICT (30f FAIL, long100 PASS)"
        new_rows.append((g, n, da, dp, verdict))
    summary = (f"tiebreak {cand_name} vs {ctrl_name} at length: ATE "
               f"{fL_ate:.3f} vs {cL_ate:.3f} cm (d{d_ate:+.3f}, margin "
               f"{margin_l:.3f}), PSNR {fL_psnr:.2f} vs {cL_psnr:.2f} "
               f"(d{d_psnr:+.2f}) -> {long_verdict} for covered rows "
               f"{sorted(covered)}")
    return new_rows, long_verdict, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--control", required=True,
                    help="group name (seed-stripped) to compare against")
    ap.add_argument("--rel-tol", type=float, default=0.10,
                    help="relative ATE contract margin (default 10%%)")
    ap.add_argument("--psnr-tol", type=float, default=0.5,
                    help="allowed PSNR drop in dB (default 0.5)")
    ap.add_argument("--tiebreak", default=None,
                    metavar="CONTROL_LONG:CANDIDATE_LONG",
                    help="long-run drift-shape group pair; upgrades "
                         "PROVISIONAL verdicts of covered rows")
    ap.add_argument("--tiebreak-covers", default=TIEBREAK_COVERS_DEFAULT,
                    help="comma list of groups the tiebreaker covers "
                         f"(default: {TIEBREAK_COVERS_DEFAULT})")
    args = ap.parse_args(argv)
    groups = collect(args.dirs)
    c_med, noise, margin, rows = adjudicate(
        groups, args.control, args.rel_tol, args.psnr_tol)
    print(f"control={args.control}: ATE median {c_med:.3f} cm, seed "
          f"range (noise) {noise:.3f} cm, contract margin "
          f"{margin:.3f} cm")
    if args.tiebreak:
        rows, _, summary = apply_tiebreak(
            groups, rows, noise, args.tiebreak, args.tiebreak_covers,
            args.rel_tol, args.psnr_tol)
        print(summary)
    # groups from other protocols are never candidates against the
    # 30-frame control: long-run rows are tiebreak evidence; bridge_*
    # rows run the REAL Replica config (different iteration counts)
    rows = [r for r in rows
            if not r[0].startswith(("long", "bridge"))]
    print(f"{'config':<18} {'n':>2} {'dATE(cm)':>9} {'dPSNR':>7} verdict")
    for g, n, d_ate, d_psnr, verdict in rows:
        print(f"{g:<18} {n:>2} {d_ate:>+9.3f} {d_psnr:>+7.2f} {verdict}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
