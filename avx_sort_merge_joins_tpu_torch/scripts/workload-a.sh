#!/usr/bin/env bash
# Workload A of the port -- the 1.6B x 1.6B m-way join on 8 shards of one
# card (the twin of scripts/workload-a.sh; reference:
# scripts/tput-scalability.sh:15-16,27-38).
#
# The CLI routes sizes >= SMJ_SHARDED_GEN_MIN (default 500M) with -n > 1
# through the scale tier (parallel/scale.py): each shard's columns made on
# the card, the pre-sharded distributed m-way (local K1 + K2 sort,
# equi-depth splitters, the exchange between shards, varlen K2 merge, K3
# count), then Results = |S|.
#
# The full run:
#   avx_sort_merge_joins_tpu_torch/scripts/workload-a.sh
# Parameterized:
#   .../workload-a.sh --devices 8 --ntuples 1600000000 [--skew 0.75]
# Small, on the CPU (the same entry point and code path):
#   DEVICE=cpu .../workload-a.sh --devices 8 --ntuples 400000 \
#     --scale-min 100000
set -u
# the port's allocator default (types.ALLOC_CONF_DEFAULT)
export PYTORCH_CUDA_ALLOC_CONF="${PYTORCH_CUDA_ALLOC_CONF:-expandable_segments:True}"
DEVICES=8
NTUPLES=1600000000
SKEW=0
SCALE_MIN=""
while [[ $# -gt 0 ]]; do
  case "$1" in
    --devices)   DEVICES=$2; shift 2;;
    --ntuples)   NTUPLES=$2; shift 2;;
    --skew)      SKEW=$2; shift 2;;
    --scale-min) SCALE_MIN=$2; shift 2;;
    *) echo "usage: $0 [--devices N] [--ntuples N] [--skew Z] [--scale-min N]" >&2
       exit 2;;
  esac
done
[[ -n "$SCALE_MIN" ]] && export SMJ_SHARDED_GEN_MIN="$SCALE_MIN"

cd "$(dirname "$0")/../.."
out=$(python -m avx_sort_merge_joins_tpu_torch -a m-way -n "$DEVICES" \
        -r "$NTUPLES" -s "$NTUPLES" -z "$SKEW" \
        ${DEVICE:+--device "$DEVICE"}) || {
  echo "[workload-a] driver FAILED" >&2; exit 1; }
echo "$out"
# exactness gate: the pk-fk workload's count must equal |S|
if [[ "$out" != *"Results = $NTUPLES"* ]]; then
  echo "[workload-a] FAIL: expected 'Results = $NTUPLES'" >&2
  exit 1
fi
echo "[workload-a] PASS: count == |S| == $NTUPLES over $DEVICES shards"
