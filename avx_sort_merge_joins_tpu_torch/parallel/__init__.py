"""Distributed joins over a mesh of shards (counterpart of
``avx_sort_merge_joins_tpu/parallel/``): the mesh and its collectives, the
bucket exchange, the chunk-gated receiver merge (K9) and the distributed
m-way and range-partition count joins."""
