"""Operators: block sorts (K1 keys only, K5 pairs), multiway merge (K2),
pairwise merge pass (K4) and the fused match count (K3), each a CUDA kernel
with its plain PyTorch version; the pair sort and the tag-merge count built
on them."""
