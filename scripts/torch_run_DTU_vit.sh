#!/usr/bin/env bash
# DTU reconstruction with the port's frozen-DINOv2 ViT extractor.
set -euo pipefail
EXTRACTOR=vit exec "$(dirname "$0")/torch_run_DTU_sift.sh" "$@"
