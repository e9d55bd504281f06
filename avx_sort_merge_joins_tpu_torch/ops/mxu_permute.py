"""Histogram and lane permutation (counterpart of
``avx_sort_merge_joins_tpu/ops/mxu_permute.py:42-115``).

The JAX package runs both on the TPU's matrix unit (MXU): a histogram as a
rank-2 one-hot matmul, a per-lane gather as one-hot matmuls over byte
planes, with chunking (``_EXACT_CHUNK``) to keep float32 sums exact.  The
H100 has no MXU to borrow and PyTorch has both operations: ``onehot_hist``
is a histogram and ``permute_lanes`` a ``torch.gather``.  They are plain
torch, no kernel, and exact without chunking.  The names stay so that a
reader finds the counterpart.
"""

from __future__ import annotations

import torch


def onehot_hist(pid: torch.Tensor, fanout: int) -> torch.Tensor:
    """Histogram of ``pid`` (any shape) over ``[0, fanout)``: ``(fanout,)``
    int32.  Values outside that range are not counted (the JAX function's
    pads equal ``fanout`` and never count)."""
    if fanout < 1 or fanout & (fanout - 1):
        raise ValueError(f"onehot_hist: fanout {fanout} is not a power of 2")
    flat = pid.reshape(-1).to(torch.int64)
    live = flat[(flat >= 0) & (flat < fanout)]
    return torch.bincount(live, minlength=fanout).to(torch.int32)


def permute_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather ``y[r, j] = x[r, idx[r, j]]`` of ``(rows, L)`` int32
    tensors."""
    if x.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"permute_lanes: x {tuple(x.shape)} and idx "
                         f"{tuple(idx.shape)} are not (rows, L)")
    return torch.gather(x, 1, idx.to(torch.int64))
