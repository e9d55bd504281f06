"""Engine constants of the PyTorch/CUDA port (counterpart of
``avx_sort_merge_joins_tpu/params.py``).

Sizes are in keys.  The TPU package's VMEM budget, lane width and
partition slack have no counterpart here: the port's layouts are flat 1-D
tensors, and its block size follows the H100's shared memory.  The radix
partitioning constants (histogram tile, largest fanout, alignment) live in
``ops/partition.py``.
"""

from __future__ import annotations

# Keys sorted per block by the block-sort kernel: the reference's L2 block
# (avxsort.c:16-18).  16,384 int32 keys are 64 KB of shared memory per CTA.
BLOCKSIZE_DEFAULT = 16384
