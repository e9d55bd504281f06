"""Operators: block sorts (K1 keys only, K5 pairs), multiway merges (K2 keys
only, K6 pairs), pairwise merge pass (K4), the fused match counts (K3
int32 keys, K7 64-bit keys, K10 two runs a side) and the radix histogram
(K8), each a CUDA kernel with its plain PyTorch version; the pair sorts,
the 2-way merge facade, the tag-merge count, materialization, the KEY_8B
join and radix partitioning built on them."""
