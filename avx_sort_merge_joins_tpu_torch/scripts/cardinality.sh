#!/bin/bash
# Cardinality experiment of the port -- S/R in {1,2,4,8,16} with R fixed
# (the twin of scripts/cardinality.sh; reference: scripts/cardinality.sh:30-48).
# DEVICE=cpu runs the plain PyTorch versions on the CPU (default: the card).
set -u
# run from anywhere: put the repo root on PYTHONPATH
export PYTHONPATH="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd):${PYTHONPATH:-}"
# the port's allocator default (types.ALLOC_CONF_DEFAULT)
export PYTORCH_CUDA_ALLOC_CONF="${PYTORCH_CUDA_ALLOC_CONF:-expandable_segments:True}"
NR=${NR:-134217728}
ALGO=${ALGO:-m-way}
REPS=${REPS:-3}
LOG=${LOG:-cardinality.log}
OUT=${OUT:-cardinality.txt}

for ratio in 1 2 4 8 16; do
  NS=$((NR * ratio))
  for rep in $(seq 1 "$REPS"); do
    echo "# ratio=$ratio rep=$rep" >> "$LOG"
    python -m avx_sort_merge_joins_tpu_torch -a "$ALGO" -r "$NR" -s "$NS" \
      ${DEVICE:+--device "$DEVICE"} >> "$OUT" 2>> "$LOG"
  done
done
