#!/usr/bin/env bash
# HPatches sequence run with the port's SIFT extractor (PyTorch/CUDA).
# Counterpart of scripts/run_HPatches_sift.sh: SIMPLE_RADIAL cameras, no dense
# reconstruction guarantees (sequences are planar).  OUTPUT_ROOT defaults to
# <repo>/data; arguments after the scene name go to the pipeline (e.g.
# --device cpu).
set -euo pipefail

SEQ=${1:?usage: torch_run_HPatches_sift.sh <sequence-dir> [scene-name] [pipeline flags...]}
SCENE=${2:-$(basename "$SEQ")}
ROOT=$(cd "$(dirname "$0")/.." && pwd)
OUTPUT_ROOT=${OUTPUT_ROOT:-$ROOT/data}
EXTRACTOR=${EXTRACTOR:-colmap_sift}
DATASET=HPatches

WORK="$OUTPUT_ROOT/intermediate/$DATASET/$SCENE"
IMAGES="$WORK/images"
DB="$WORK/database.db"
OUT="$OUTPUT_ROOT/outputs/$DATASET/$SCENE/$EXTRACTOR"
RESULTS="$OUTPUT_ROOT/results"

mkdir -p "$IMAGES" "$OUT"
rm -f "$DB"
find "$IMAGES" -maxdepth 1 -type l -delete

shopt -s nullglob
files=("$SEQ"/*.ppm "$SEQ"/*.png "$SEQ"/*.jpg)
if [ ${#files[@]} -eq 0 ]; then echo "no images in $SEQ"; exit 1; fi
for f in "${files[@]}"; do ln -sf "$(readlink -f "$f")" "$IMAGES/"; done
echo "Linked ${#files[@]} images for $DATASET/$SCENE"

PYTHONPATH="$ROOT" python3 -m vit_colmap_tpu_torch.pipeline \
  --images "$IMAGES" \
  --output "$OUT" \
  --db "$DB" \
  --extractor "$EXTRACTOR" \
  --camera-model SIMPLE_RADIAL \
  --dataset "$DATASET" \
  --scene "$SCENE" \
  --export-metrics "$RESULTS" \
  "${@:3}"
