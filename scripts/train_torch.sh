#!/usr/bin/env bash
# Shell launcher for training with the PyTorch/CUDA port (the counterpart of
# train.sh, reference UNet/train.sh role). Trains on the card; pass
# `--device cpu` to train on the CPU.
# Edit the variables below, or pass extra flags through: ./train_torch.sh [--flag v ...]
# Defaults anchor at the repo root; user-supplied paths resolve from the
# caller's cwd — the script never cd's, so relative overrides keep working.
set -euo pipefail

REPO_DIR="$(cd "$(dirname "$0")/.." && pwd)"
TRAIN_DATABASE="${TRAIN_DATABASE:-${REPO_DIR}/data/train-HES.lmdb}"
TEST_DATABASE="${TEST_DATABASE:-${REPO_DIR}/data/test-HES.lmdb}"
OUTPUT_DIR="${OUTPUT_DIR:-${REPO_DIR}/output}"
BATCH_SIZE="${BATCH_SIZE:-4}"
NUMBER_CLASSES="${NUMBER_CLASSES:-2}"
LEARNING_RATE="${LEARNING_RATE:-3e-4}"
USE_AUGMENTATION="${USE_AUGMENTATION:-1}"
BALANCE_CLASSES="${BALANCE_CLASSES:-0}"
READER_COUNT="${READER_COUNT:-1}"

export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:${PYTHONPATH}}"
exec python -m tpuseg_torch.cli.train \
  --train_database "${TRAIN_DATABASE}" \
  --test_database "${TEST_DATABASE}" \
  --output_dir "${OUTPUT_DIR}" \
  --batch_size "${BATCH_SIZE}" \
  --number_classes "${NUMBER_CLASSES}" \
  --learning_rate "${LEARNING_RATE}" \
  --use_augmentation "${USE_AUGMENTATION}" \
  --balance_classes "${BALANCE_CLASSES}" \
  --reader_count "${READER_COUNT}" \
  "$@"
