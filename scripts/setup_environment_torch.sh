#!/usr/bin/env bash
# Environment check for the PyTorch/CUDA port (the counterpart of
# setup_environment.sh). It installs and downloads nothing: the machine
# must already have PyTorch built for CUDA, numpy and scipy, and the CUDA
# toolkit. It checks that torch sees a card and that nvcc is found (on
# PATH, or under CUDA_HOME as tpuseg_torch/kernels/build.py looks), then
# builds the hand kernels (tpuseg_torch/csrc) into build/ ahead of their
# first use. With --cpu it only checks that torch imports, for CPU-only
# development and the CPU tests.
#
# Usage: scripts/setup_environment_torch.sh [--cpu]
set -euo pipefail

CPU=0
for arg in "$@"; do
  case "${arg}" in
    --cpu) CPU=1 ;;
    *) echo "usage: $0 [--cpu]" >&2; exit 2 ;;
  esac
done

REPO_DIR="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:${PYTHONPATH}}"

python -c "import numpy, scipy, torch; print(f'torch {torch.__version__}, CUDA {torch.version.cuda}')"
if [[ "${CPU}" == "1" ]]; then
  echo "tpuseg_torch CPU environment ready; run: python -m pytest tests/test_torch_*.py -q"
  exit 0
fi

if ! python -c "import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)"; then
  echo "torch sees no CUDA card (torch.cuda.is_available() is false); use --cpu for a" \
       "CPU-only environment" >&2
  exit 1
fi
NVCC="$(command -v nvcc || true)"
if [[ -z "${NVCC}" && -x "${CUDA_HOME:-/usr/local/cuda}/bin/nvcc" ]]; then
  NVCC="${CUDA_HOME:-/usr/local/cuda}/bin/nvcc"
fi
if [[ -z "${NVCC}" ]]; then
  echo "nvcc not found on PATH or under \${CUDA_HOME:-/usr/local/cuda}/bin" >&2
  exit 1
fi
echo "nvcc: ${NVCC}"

python -c "
from tpuseg_torch.kernels import build
for name, path in sorted(build.build().items()):
    print(f'built {name}: {path}')
"
echo "tpuseg_torch environment ready; run: python3 chip_smoke.py"
