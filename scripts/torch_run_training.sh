#!/usr/bin/env bash
# Canonical training launch on the port (PyTorch/CUDA): the reference's
# hyperparameters (all_pairs, synthetic ratio 0.5, alpha_orient 0.32) at batch
# size 4, as scripts/run_training.sh.  Checkpoints go to $CHECKPOINTS (default
# <repo>/checkpoints); flags after the data root go to the trainer (e.g.
# --device cpu).
set -euo pipefail
ROOT=$(cd "$(dirname "$0")/.." && pwd)
DATA=${1:?usage: torch_run_training.sh <hpatches-root> [extra flags...]}
CHECKPOINTS=${CHECKPOINTS:-$ROOT/checkpoints}

PYTHONPATH="$ROOT" python3 -m vit_colmap_tpu_torch.training.train \
  --data-dir "$DATA" \
  --pair-mode all_pairs \
  --synthetic-ratio 0.5 \
  --alpha-orient 0.32 \
  --batch-size 4 \
  --epochs 20 \
  --output-dir "$CHECKPOINTS" \
  "${@:2}"
