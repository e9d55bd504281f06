#!/bin/bash
# Multiway-merge micro grid of the port -- totals x fan-in sweep vs
# torch.sort vs copy (the twin of scripts/multiwaymerge-bench.sh;
# reference: scripts/multiwaymerge-bench.sh:19-41).
# DEVICE=cpu runs the plain PyTorch versions on the CPU (default: the card).
set -u
# run from anywhere: put the repo root on PYTHONPATH
export PYTHONPATH="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd):${PYTHONPATH:-}"
# the port's allocator default (types.ALLOC_CONF_DEFAULT)
export PYTORCH_CUDA_ALLOC_CONF="${PYTORCH_CUDA_ALLOC_CONF:-expandable_segments:True}"
TOTALS=${TOTALS:-"4194304 8388608 16777216"}
FANINS=${FANINS:-"4 8 16 32 64"}
OUT=${OUT:-multiwaymerge-bench.txt}

for total in $TOTALS; do
  for f in $FANINS; do
    chunk=$((total / f))
    python -m avx_sort_merge_joins_tpu_torch.bench.multiwaymergebench \
      "$chunk" "$f" ${DEVICE:+--device "$DEVICE"} >> "$OUT" \
      2>> "${OUT%.txt}.log"
  done
done
