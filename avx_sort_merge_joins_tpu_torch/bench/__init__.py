"""Micro-benchmarks of the port (counterpart of
``avx_sort_merge_joins_tpu/bench/``; reference: src/bench/ -- bench_sort,
bench_merge, bench_multiwaymerge, bench_partitioning, tputbench, and
scripts/tput-scalability.sh's grid as ``scalebench``).

Run as modules, on the card by default (``--device cpu`` for the plain
PyTorch versions; without a card they exit 1):

    python -m avx_sort_merge_joins_tpu_torch.bench.sortbench 16 multiway
    python -m avx_sort_merge_joins_tpu_torch.bench.partitioningbench \
        8388608 all 7
    python -m avx_sort_merge_joins_tpu_torch.bench.scalebench 134217728 \
        --devices 1,2,4,8,2x4
    python -m avx_sort_merge_joins_tpu_torch.bench.tputbench --mode numa

Each prints the JAX module's record line on stdout and a labelled line
with the device's name on stderr, after checking its own output.
``kernel_variants`` is no port of a reference bench: on the card, from
the root of a checkout, it times design alternatives of kernels K1 and
K11 against the committed ones.
"""
