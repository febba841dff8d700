#!/usr/bin/env bash
# Example invocations of scripts/torch_visualize_invariant_points.py (the
# port's counterpart of scripts/run_visualize_invariant_points.sh): how the
# training sampler selects invariant points by warped cosine similarity.
# DATA is an HPatches-layout root (default: the port's bake-off tree).
# Drawing needs matplotlib.
set -euo pipefail
ROOT=$(cd "$(dirname "$0")/.." && pwd)
DATA=${DATA:-$ROOT/results/quality_torch/hpatches}

python3 "$ROOT/scripts/torch_visualize_invariant_points.py" \
    --data-root "$DATA" \
    --sequence v_synth0 \
    --pair-idx 0 \
    --top-k-invariant 1024 \
    --min-similarity 0.9 \
    --no-labels \
    --dpi 300 \
    "$@"

### With per-point similarity labels (slower to render):
# python3 "$ROOT/scripts/torch_visualize_invariant_points.py" \
#     --data-root "$DATA" --sequence i_synth0 --pair-idx 0 \
#     --max-points 100 --top-k-invariant 1024 --font-size 6 --dpi 300
