#!/bin/bash
# Partitioning micro grid of the port -- 8M tuples x radix bits 2..16 x
# variants (the twin of scripts/partitioning-bench.sh; reference:
# scripts/partitioning-bench.sh:17-33).
# DEVICE=cpu runs the plain PyTorch versions on the CPU (default: the card).
set -u
# run from anywhere: put the repo root on PYTHONPATH
export PYTHONPATH="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd):${PYTHONPATH:-}"
# the port's allocator default (types.ALLOC_CONF_DEFAULT)
export PYTORCH_CUDA_ALLOC_CONF="${PYTORCH_CUDA_ALLOC_CONF:-expandable_segments:True}"
N=${N:-8388608}
BITS=${BITS:-"2 4 6 8 10 12 14 16"}
OUT=${OUT:-partitioning-bench.txt}

for b in $BITS; do
  python -m avx_sort_merge_joins_tpu_torch.bench.partitioningbench "$N" all \
    "$b" ${DEVICE:+--device "$DEVICE"} >> "$OUT" 2>> "${OUT%.txt}.log"
done
