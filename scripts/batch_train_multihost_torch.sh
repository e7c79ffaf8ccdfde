#!/usr/bin/env bash
# Multi-node, multi-GPU training with the PyTorch/CUDA port: one process per
# GPU under torchrun, data-parallel (DDP with sync-BN; ZeRO-1 with
# --shard_optimizer 1). The port's counterpart of batch_train_multihost.sh.
#
# Run the SAME command once per node. torchrun numbers the ranks
# host-contiguously and exports RANK / WORLD_SIZE / LOCAL_RANK /
# LOCAL_WORLD_SIZE / MASTER_ADDR / MASTER_PORT, which
# `tpuseg_torch.cli.train --multihost 1` joins (NCCL on the cards).
#
#   one node, all its GPUs:
#     TRAIN_DATABASE=... TEST_DATABASE=... ./scripts/batch_train_multihost_torch.sh
#   Slurm (one task per node):
#     sbatch --nodes=4 --ntasks-per-node=1 --gpus-per-node=8 \
#       --wrap="srun env NNODES=4 NODE_RANK=\$SLURM_PROCID MASTER_ADDR=<node0> \
#               scripts/batch_train_multihost_torch.sh"
#
# --batch_size stays PER GPU: the global batch is batch_size x world size,
# and each rank's readers produce only its slice.
set -euo pipefail

TRAIN_DATABASE="${TRAIN_DATABASE:?set TRAIN_DATABASE}"
TEST_DATABASE="${TEST_DATABASE:?set TEST_DATABASE}"
OUTPUT_DIR="${OUTPUT_DIR:-./results-multihost-torch}"
BATCH_SIZE="${BATCH_SIZE:-8}"           # per GPU
READER_COUNT="${READER_COUNT:-2}"       # per GPU
NNODES="${NNODES:-1}"
NODE_RANK="${NODE_RANK:-${SLURM_PROCID:-0}}"
GPUS_PER_NODE="${GPUS_PER_NODE:-$(nvidia-smi -L 2>/dev/null | wc -l)}"
if ! [[ "${GPUS_PER_NODE}" =~ ^[1-9][0-9]*$ ]]; then
  echo "no GPU found: set GPUS_PER_NODE" >&2
  exit 1
fi
MASTER_ADDR="${MASTER_ADDR:-127.0.0.1}"
MASTER_PORT="${MASTER_PORT:-29500}"

mkdir -p "${OUTPUT_DIR}"

trap 'echo "TERM received, exiting"; exit 143' TERM

REPO_DIR="$(cd "$(dirname "$0")/.." && pwd)"
# Source snapshot from node 0 only — OUTPUT_DIR is typically a shared
# filesystem and N nodes racing the same tarball corrupts it.
if [[ "${NODE_RANK}" == "0" ]]; then
  git -C "${REPO_DIR}" rev-parse HEAD > "${OUTPUT_DIR}/git_commit.txt" 2>/dev/null || true
  tar -C "${REPO_DIR}" -czf "${OUTPUT_DIR}/.snapshot.$$.tar.gz" tpuseg_torch scripts 2>/dev/null \
    && mv -f "${OUTPUT_DIR}/.snapshot.$$.tar.gz" "${OUTPUT_DIR}/source_snapshot.tar.gz" || true
fi

# Per-rank logs: torchrun writes each rank's stdout and stderr under
# OUTPUT_DIR/logs_node<NODE_RANK>/<run id>/attempt_0/<local rank>/; rank 0
# alone writes the checkpoint, TensorBoard files and test_loss.csv.
export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:${PYTHONPATH}}"
python -m torch.distributed.run \
  --nnodes "${NNODES}" --node_rank "${NODE_RANK}" \
  --nproc_per_node "${GPUS_PER_NODE}" \
  --master_addr "${MASTER_ADDR}" --master_port "${MASTER_PORT}" \
  --log_dir "${OUTPUT_DIR}/logs_node${NODE_RANK}" --redirects 3 --tee 3 \
  -m tpuseg_torch.cli.train \
  --train_database "${TRAIN_DATABASE}" \
  --test_database "${TEST_DATABASE}" \
  --output_dir "${OUTPUT_DIR}" \
  --batch_size "${BATCH_SIZE}" \
  --reader_count "${READER_COUNT}" \
  --multihost 1 \
  "$@" 2>&1 | tee "${OUTPUT_DIR}/log_node${NODE_RANK}.txt"
