#!/bin/bash
# Aggregate eval_summary.json across Replica runs into a CSV (counterpart
# of bash_scripts/run_replica_eval_all.sh: the same CSV, then the port's
# tools.compare_expected).
OUT="${1:-experiments/Replica/eval_all.csv}"
echo "scene,ate_rmse_cm,psnr,depth_l1_cm,ms_ssim,lpips" > "$OUT"
for scene in room0 room1 room2 office0 office1 office2 office3 office4; do
  f="experiments/Replica/${scene}_0/eval/eval_summary.json"
  [ -f "$f" ] || continue
  python - "$scene" "$f" >> "$OUT" <<'PY'
import json, sys
scene, path = sys.argv[1], sys.argv[2]
d = json.load(open(path))
print(f"{scene},{d.get('Final Average ATE RMSE (cm)','')},"
      f"{d.get('Average PSNR','')},{d.get('Average Depth L1 (cm)','')},"
      f"{d.get('Average MS-SSIM','')},{d.get('Average LPIPS','')}")
PY
done
cat "$OUT"

# mechanical comparison against the recorded reference numbers (room0 is
# the only scene with published baseline values; see
# configs/replica/expected_metrics.json)
summaries=()
for scene in room0 room1 room2 office0 office1 office2 office3 office4; do
  f="experiments/Replica/${scene}_0/eval/eval_summary.json"
  [ -f "$f" ] && summaries+=("${scene}=${f}")
done
if [ "${#summaries[@]}" -gt 0 ]; then
  python -m isogs_slam_tpu_torch.tools.compare_expected \
      configs/replica/expected_metrics.json "${summaries[@]}"
fi
