#!/usr/bin/env bash
# HPatches run with the port's trained keypoint/descriptor heads.
# VIT_WEIGHTS=<dir> loads a checkpoint directory of the port's trainer.
set -euo pipefail
EXTRA=()
if [ -n "${VIT_WEIGHTS:-}" ]; then EXTRA+=(--vit-weights "$VIT_WEIGHTS"); fi
EXTRACTOR=trainable_vit exec "$(dirname "$0")/torch_run_HPatches_sift.sh" "$1" "${2:-}" \
  "${EXTRA[@]}" "${@:3}"
