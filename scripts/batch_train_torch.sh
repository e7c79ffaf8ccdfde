#!/usr/bin/env bash
# Cluster batch job for training with the PyTorch/CUDA port (the
# counterpart of batch_train.sh, reference UNet/sbatch_train.sh role): one
# process on one GPU. For several GPUs or nodes use
# batch_train_multihost_torch.sh (torchrun, one process per GPU).
#
# Usage under Slurm:   sbatch --ntasks=1 --gpus=1 --cpus-per-task=16 batch_train_torch.sh
# Usage standalone:    ./batch_train_torch.sh
#
# The script never cd's: relative TRAIN/TEST_DATABASE and OUTPUT_DIR resolve
# against the caller's cwd for their whole lifetime.
set -euo pipefail

TRAIN_DATABASE="${TRAIN_DATABASE:?set TRAIN_DATABASE}"
TEST_DATABASE="${TEST_DATABASE:?set TEST_DATABASE}"
OUTPUT_DIR="${OUTPUT_DIR:-./results-$(date +%Y%m%dT%H%M%S)}"
BATCH_SIZE="${BATCH_SIZE:-8}"           # per GPU
READER_COUNT="${READER_COUNT:-2}"       # per GPU

mkdir -p "${OUTPUT_DIR}"

# Exit on scheduler TERM (reference sbatch_train.sh:40-47) with a nonzero
# status: a preempted half-finished run must not report COMPLETED to
# afterok-dependent jobs.
trap 'echo "TERM received, exiting"; exit 143' TERM

# stage databases to node-local scratch when available (sbatch_train.sh:59-66),
# in distinct train/ and test/ subdirs so same-basename databases stay apart
if [[ -n "${SLURM_JOB_ID:-}" && -d /scratch ]]; then
  SCRATCH="/scratch/${SLURM_JOB_ID}"
  mkdir -p "${SCRATCH}/train" "${SCRATCH}/test"
  cp -r "${TRAIN_DATABASE}" "${SCRATCH}/train/"
  cp -r "${TEST_DATABASE}" "${SCRATCH}/test/"
  TRAIN_DATABASE="${SCRATCH}/train/$(basename "${TRAIN_DATABASE}")"
  TEST_DATABASE="${SCRATCH}/test/$(basename "${TEST_DATABASE}")"
fi

# snapshot the source into the results dir for reproducibility (sbatch_train.sh:72-73)
REPO_DIR="$(cd "$(dirname "$0")/.." && pwd)"
git -C "${REPO_DIR}" rev-parse HEAD > "${OUTPUT_DIR}/git_commit.txt" 2>/dev/null || true
tar -C "${REPO_DIR}" -czf "${OUTPUT_DIR}/source_snapshot.tar.gz" tpuseg_torch scripts 2>/dev/null || true

export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:${PYTHONPATH}}"
python -m tpuseg_torch.cli.train \
  --train_database "${TRAIN_DATABASE}" \
  --test_database "${TEST_DATABASE}" \
  --output_dir "${OUTPUT_DIR}" \
  --batch_size "${BATCH_SIZE}" \
  --reader_count "${READER_COUNT}" \
  "$@" 2>&1 | tee "${OUTPUT_DIR}/log.txt"
