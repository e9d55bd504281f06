#!/bin/bash
# Sort micro grid of the port -- {1..256} * 2^20 tuples x variants x
# pow2/non-pow2 (the twin of scripts/sort-bench.sh; reference:
# scripts/sort-bench.sh:14-31).  The port's `torch` variant (one torch.sort)
# takes the place of the JAX `xla`.
# DEVICE=cpu runs the plain PyTorch versions on the CPU (default: the card).
set -u
# run from anywhere: put the repo root on PYTHONPATH
export PYTHONPATH="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd):${PYTHONPATH:-}"
# the port's allocator default (types.ALLOC_CONF_DEFAULT)
export PYTORCH_CUDA_ALLOC_CONF="${PYTORCH_CUDA_ALLOC_CONF:-expandable_segments:True}"
SIZES=${SIZES:-"1 2 4 8 16 32 64 128 256"}
VARIANTS=${VARIANTS:-"pairwise multiway keysonly torch"}
OUT=${OUT:-sort-bench.txt}

for v in $VARIANTS; do
  for m in $SIZES; do
    python -m avx_sort_merge_joins_tpu_torch.bench.sortbench "$m" "$v" \
      ${DEVICE:+--device "$DEVICE"} >> "$OUT" 2>> "${OUT%.txt}.log"
    # non-pow2 size (reference runs both)
    python -m avx_sort_merge_joins_tpu_torch.bench.sortbench "$m.5" "$v" \
      ${DEVICE:+--device "$DEVICE"} >> "$OUT" 2>> "${OUT%.txt}.log"
  done
done
