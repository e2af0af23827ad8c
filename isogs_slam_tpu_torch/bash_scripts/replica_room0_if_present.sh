#!/usr/bin/env bash
# Real-data contingency (counterpart of bash_scripts/replica_room0_if_present.sh,
# on the card; DEVICE=cpu runs it on the CPU): if a Replica dataset appears
# on disk, run room0 end-to-end + the expected-metrics gate; it skips
# cleanly (exit 0, "skipped") while data is absent.
#
# Usage: bash isogs_slam_tpu_torch/bash_scripts/replica_room0_if_present.sh [end_at] [outdir]
#   end_at  — frame cap (default 200: the short-run metric-regression
#             protocol from SURVEY §4; pass 2000 for the full scene)
#   outdir  — artifact dir for the summary copy (default artifacts/realdata)
set -u
cd "$(dirname "$0")/../.."

END_AT="${1:-200}"
ART="${2:-artifacts/realdata}"
DEVICE="${DEVICE:-cuda}"

# candidate dataset roots, most specific first (the config default is
# ./data/Replica per configs/replica/splatam.py:22)
ROOT=""
for r in ./data/Replica /root/data/Replica /data/Replica \
         /root/datasets/Replica ./data/replica; do
    if [ -f "$r/room0/traj.txt" ] && ls "$r/room0/results"/frame*.jpg \
            > /dev/null 2>&1; then
        ROOT="$r"
        break
    fi
done
if [ -z "$ROOT" ]; then
    echo "[realdata] no Replica dataset on disk (checked ./data/Replica "
    echo "[realdata] and friends) — skipped"
    exit 0
fi

echo "[realdata] found Replica at $ROOT — running room0 to frame $END_AT"
mkdir -p "$ART"
SEQ_DIR="experiments/Replica/room0_0"
rm -rf "$SEQ_DIR"
SPLATAM_SCENE_INDEX=0 python -m isogs_slam_tpu_torch.scripts.splatam \
    configs/replica/splatam.py --end-at "$END_AT" \
    --set data.basedir="$ROOT" --device "$DEVICE" 2>&1 \
    | tee "$ART/room0_run.log" | tail -20
rc=${PIPESTATUS[0]}
if [ -s "$SEQ_DIR/eval/eval_summary.json" ]; then
    cp "$SEQ_DIR/eval/eval_summary.json" "$ART/room0_eval_summary.json"
    cp "$SEQ_DIR/runtime_stats.json" "$ART/room0_runtime_stats.json" \
        2>/dev/null || true
    python -m isogs_slam_tpu_torch.tools.compare_expected \
        configs/replica/expected_metrics.json \
        "room0=$SEQ_DIR/eval/eval_summary.json" \
        | tee "$ART/room0_expected_gate.txt" || true
    git add -A "$ART" && git commit -q -m \
        "Measurement artifacts: REAL Replica room0 run (end_at=$END_AT)" \
        -- "$ART" || true
    echo "[realdata] room0 summary + gate committed to $ART"
else
    echo "[realdata] run FAILED rc=$rc — no summary produced"
    exit 1
fi
