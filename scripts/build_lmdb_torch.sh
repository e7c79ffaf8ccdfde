#!/usr/bin/env bash
# Shell launcher for dataset construction with the PyTorch/CUDA port's data
# tools (the counterpart of build_lmdb.sh, reference UNet/build_lmdb.sh
# role; host only, no card needed).
# Defaults anchor at the repo root (REPO_DIR/data like the reference's
# <repo>/data layout); user-supplied paths resolve from the caller's cwd —
# the script never cd's, so relative overrides keep working.
set -euo pipefail

REPO_DIR="$(cd "$(dirname "$0")/.." && pwd)"
IMAGE_FOLDER="${IMAGE_FOLDER:-${REPO_DIR}/data/images}"
MASK_FOLDER="${MASK_FOLDER:-${REPO_DIR}/data/masks}"
OUTPUT_FOLDER="${OUTPUT_FOLDER:-${REPO_DIR}/data}"
DATASET_NAME="${DATASET_NAME:-HES}"
TRAIN_FRACTION="${TRAIN_FRACTION:-0.8}"
IMAGE_FORMAT="${IMAGE_FORMAT:-tif}"
USE_TILING="${USE_TILING:-0}"
TILE_SIZE="${TILE_SIZE:-512}"

export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:${PYTHONPATH}}"
exec python -m tpuseg_torch.cli.build_lmdb \
  --image_folder "${IMAGE_FOLDER}" \
  --mask_folder "${MASK_FOLDER}" \
  --output_folder "${OUTPUT_FOLDER}" \
  --dataset_name "${DATASET_NAME}" \
  --train_fraction "${TRAIN_FRACTION}" \
  --image_format "${IMAGE_FORMAT}" \
  --use_tiling "${USE_TILING}" \
  --tile_size "${TILE_SIZE}" \
  "$@"
