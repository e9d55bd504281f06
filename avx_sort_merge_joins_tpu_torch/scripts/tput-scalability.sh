#!/bin/bash
# Thread(shard)-scaling experiment of the port -- the twin of
# scripts/tput-scalability.sh (reference: scripts/tput-scalability.sh:
# algos x {64..1} threads x reps, AVX and scalar, record format
#  "ALGO NTHREADS RUNNO PARTCYC SORTCYC MERGE1CYC MERGERESTCYC MJOINCYC
#   NUMTUP USECS TPUT", :27-38 and :47-60 for the scalar sweep).
# Shards of one card replace threads (-n N); cycles are reported as
# microseconds; every config runs twice -- the CUDA kernels and the scalar
# (torch.sort) baseline -- mirroring the reference's AVX vs scalar double
# sweep.  [RECORD] rows on stderr are grepped into OUT so rows are
# comparable column-for-column.
# DEVICE=cpu runs the plain PyTorch versions on the CPU (default: the card).
set -u
# run from anywhere: put the repo root on PYTHONPATH
export PYTHONPATH="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd):${PYTHONPATH:-}"
# the port's allocator default (types.ALLOC_CONF_DEFAULT)
export PYTORCH_CUDA_ALLOC_CONF="${PYTORCH_CUDA_ALLOC_CONF:-expandable_segments:True}"
NR=${NR:-134217728}
NS=${NS:-$NR}
REPS=${REPS:-3}
CHIPS=${CHIPS:-"1"}       # shards of the card's mesh, e.g. "8 4 2 1"
ALGOS=${ALGOS:-"m-way m-pass mpsm"}
LOG=${LOG:-tput-scalability.log}
OUT=${OUT:-tput-scalability.txt}

run_one() {  # algo shards rep extra-flags...
  local algo=$1 n=$2 rep=$3; shift 3
  local tag=$*
  echo "# $algo chips=$n rep=$rep ${tag:-cuda}" >> "$LOG"
  # capture stderr synchronously to a temp file, then append sequentially:
  # concurrent process substitutions interleave $LOG lines and bash's
  # `wait` does not cover them, which could drop the final [RECORD] row
  local errtmp
  errtmp=$(mktemp)
  python -m avx_sort_merge_joins_tpu_torch -a "$algo" -n "$n" \
    -r "$NR" -s "$NS" "$@" ${DEVICE:+--device "$DEVICE"} >> "$LOG" \
    2> "$errtmp"
  cat "$errtmp" >> "$LOG"
  grep -E '^\[RECORD\]' "$errtmp" | sed "s/\$/ ${tag:-cuda}/" >> "$OUT"
  rm -f "$errtmp"
}

for algo in $ALGOS; do
  for n in $CHIPS; do
    for rep in $(seq 1 "$REPS"); do
      run_one "$algo" "$n" "$rep"                       # CUDA kernels
      run_one "$algo" "$n" "$rep" --scalarsort --scalarmerge  # scalar sweep
    done
  done
done
