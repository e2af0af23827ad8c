#!/bin/bash
# Environment check of the PyTorch/CUDA port (counterpart of
# bash_scripts/start_env.bash): the torch runtime and the card, the port's
# CUDA kernels built into isogs_slam_tpu_torch/_build/, the native library,
# then the installation self-check on the card. DEVICE=cpu checks the CPU
# path instead (no card queried, no kernel built: the CPU runs the kernels'
# plain versions); without it a missing card is an error, not a fallback.
set -e
cd "$(dirname "$0")/../.."
DEVICE="${DEVICE:-cuda}"

echo "== python/torch =="
python - "$DEVICE" <<'PY'
import sys
import torch
print("torch", torch.__version__, "cuda available", torch.cuda.is_available())
if sys.argv[1] != "cpu" and not torch.cuda.is_available():
    sys.exit("no CUDA device (DEVICE=cpu checks the CPU path)")
PY
if [ "$DEVICE" != "cpu" ]; then
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    echo "== CUDA kernels =="
    python -c "from isogs_slam_tpu_torch.ops import _cuda; _cuda.build(); \
print('built', ', '.join(_cuda.SOURCES), 'in', _cuda.BUILD_DIR)"
fi

echo "== native library =="
./native/build.sh

echo "== installation self-check =="
python -m isogs_slam_tpu_torch.scripts.test_installation --device "$DEVICE"

echo "environment ready"
