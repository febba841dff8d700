#!/usr/bin/env bash
# DTU reconstruction with the port's SIFT extractor (PyTorch/CUDA).
# Counterpart of scripts/run_DTU_sift.sh: selects the diffuse lighting images
# (*_3_r5000.png, fallback frame_*.png, then any PNG/JPG), symlinks them into
# $OUTPUT_ROOT/intermediate/<dataset>/<scene>/images, clears the stale DB, and
# runs python -m vit_colmap_tpu_torch.pipeline with PINHOLE cameras and the
# metric export.  OUTPUT_ROOT defaults to <repo>/data; arguments after the
# scene name go to the pipeline (e.g. --device cpu).
set -euo pipefail

SCAN=${1:?usage: torch_run_DTU_sift.sh <scan-dir> [scene-name] [pipeline flags...]}
SCENE=${2:-$(basename "$SCAN")}
ROOT=$(cd "$(dirname "$0")/.." && pwd)
OUTPUT_ROOT=${OUTPUT_ROOT:-$ROOT/data}
EXTRACTOR=${EXTRACTOR:-colmap_sift}
DATASET=DTU

WORK="$OUTPUT_ROOT/intermediate/$DATASET/$SCENE"
IMAGES="$WORK/images"
DB="$WORK/database.db"
OUT="$OUTPUT_ROOT/outputs/$DATASET/$SCENE/$EXTRACTOR"
RESULTS="$OUTPUT_ROOT/results"

mkdir -p "$IMAGES" "$OUT"
rm -f "$DB"
find "$IMAGES" -maxdepth 1 -type l -delete

shopt -s nullglob
files=("$SCAN"/*_3_r5000.png)
if [ ${#files[@]} -eq 0 ]; then files=("$SCAN"/frame_*.png); fi
if [ ${#files[@]} -eq 0 ]; then files=("$SCAN"/*.png "$SCAN"/*.jpg); fi
if [ ${#files[@]} -eq 0 ]; then echo "no images in $SCAN"; exit 1; fi
for f in "${files[@]}"; do ln -sf "$(readlink -f "$f")" "$IMAGES/"; done
echo "Linked ${#files[@]} images for $DATASET/$SCENE"

PYTHONPATH="$ROOT" python3 -m vit_colmap_tpu_torch.pipeline \
  --images "$IMAGES" \
  --output "$OUT" \
  --db "$DB" \
  --extractor "$EXTRACTOR" \
  --camera-model PINHOLE \
  --dataset "$DATASET" \
  --scene "$SCENE" \
  --export-metrics "$RESULTS" \
  "${@:3}"
