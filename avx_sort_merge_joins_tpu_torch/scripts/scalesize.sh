#!/bin/bash
# Scale-size experiment of the port -- R = S = 32M * {1..60} on one device
# (the twin of scripts/scalesize.sh; reference: scripts/scalesize.sh:31-45).
# DEVICE=cpu runs the plain PyTorch versions on the CPU (default: the card).
set -u
# run from anywhere: put the repo root on PYTHONPATH
export PYTHONPATH="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd):${PYTHONPATH:-}"
# the port's allocator default (types.ALLOC_CONF_DEFAULT)
export PYTORCH_CUDA_ALLOC_CONF="${PYTORCH_CUDA_ALLOC_CONF:-expandable_segments:True}"
ALGO=${ALGO:-m-way}
SIZES=${SIZES:-"1 2 4 8 16 24 32 40 48 56 60"}
LOG=${LOG:-scalesize.log}
OUT=${OUT:-scalesize.txt}
BASE=$((32 * 1024 * 1024))

for m in $SIZES; do
  N=$((BASE * m))
  echo "# size=${m}x32M" >> "$LOG"
  python -m avx_sort_merge_joins_tpu_torch -a "$ALGO" -r "$N" -s "$N" \
    ${DEVICE:+--device "$DEVICE"} >> "$OUT" 2>> "$LOG"
done
