#!/usr/bin/env bash
# Resume the port's training from the latest checkpoint ('latest' is the only
# checkpoint with the optimizer state; 'best_model' holds the weights alone).
# CKPT defaults to $CHECKPOINTS/latest (<repo>/checkpoints/latest).
set -euo pipefail
ROOT=$(cd "$(dirname "$0")/.." && pwd)
DATA=${1:?usage: torch_resume_training.sh <hpatches-root> [extra flags...]}
CKPT=${CKPT:-${CHECKPOINTS:-$ROOT/checkpoints}/latest}

exec "$(dirname "$0")/torch_run_training.sh" "$DATA" --resume "$CKPT" "${@:2}"
