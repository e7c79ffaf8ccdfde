#!/usr/bin/env bash
# Shell launcher for inference with the PyTorch/CUDA port (the counterpart
# of inference.sh, reference UNet/inference.sh role). Serves on the card;
# pass `--device cpu` to serve on the CPU.
# Defaults anchor at the repo root; user-supplied paths resolve from the
# caller's cwd — the script never cd's, so relative overrides keep working.
set -euo pipefail

REPO_DIR="$(cd "$(dirname "$0")/.." && pwd)"
CHECKPOINT_FILEPATH="${CHECKPOINT_FILEPATH:-${REPO_DIR}/output/checkpoint/ckpt}"
IMAGE_FOLDER="${IMAGE_FOLDER:-${REPO_DIR}/data/images}"
OUTPUT_FOLDER="${OUTPUT_FOLDER:-${REPO_DIR}/inference_output}"
NUMBER_CLASSES="${NUMBER_CLASSES:-2}"
NUMBER_CHANNELS="${NUMBER_CHANNELS:-1}"
IMAGE_FORMAT="${IMAGE_FORMAT:-tif}"

export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:${PYTHONPATH}}"
exec python -m tpuseg_torch.cli.inference \
  --checkpoint_filepath "${CHECKPOINT_FILEPATH}" \
  --image_folder "${IMAGE_FOLDER}" \
  --output_folder "${OUTPUT_FOLDER}" \
  --number_classes "${NUMBER_CLASSES}" \
  --number_channels "${NUMBER_CHANNELS}" \
  --image_format "${IMAGE_FORMAT}" \
  "$@"
