#!/usr/bin/env bash
# Example invocations of scripts/torch_visualize_matches.py (the port's
# counterpart of scripts/run_visualize_matches.sh: a cookbook wrapper, not a
# batch driver).  Point DB at any database the port's pipeline wrote, e.g. by
# scripts/torch_run_HPatches_sift.sh or torch_quality_bakeoff.py.  Drawing
# needs matplotlib; the listings do not.
set -euo pipefail
ROOT=$(cd "$(dirname "$0")/.." && pwd)
DB=${DB:-$ROOT/results/quality_torch/scene/out_sift/db.db}
IMAGES=${IMAGES:-$ROOT/results/quality_torch/scene/images}

### Explore the database first: which images / pairs have matches?
# python3 "$ROOT/scripts/torch_visualize_matches.py" --database "$DB" --list-images
# python3 "$ROOT/scripts/torch_visualize_matches.py" --database "$DB" --list-matches

### One pair, inliers green / outliers red, with scores and orientations
python3 "$ROOT/scripts/torch_visualize_matches.py" \
    --database "$DB" \
    --image-dir "$IMAGES" \
    --image1 1 \
    --image2 2 \
    --max-matches 100 \
    --dpi 300 \
    --show-all-keypoints \
    --show-scores \
    --show-orientation \
    --orientation-scale 15.0 \
    "$@"

### Every matched pair into match_viz/
# python3 "$ROOT/scripts/torch_visualize_matches.py" --database "$DB" \
#     --image-dir "$IMAGES" --all-pairs --output-dir match_viz
