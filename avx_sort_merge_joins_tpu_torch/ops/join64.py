"""64-bit-key joins -- the KEY_8B mode (counterpart of
``avx_sort_merge_joins_tpu/ops/join64.py:24-147``).

The reference's --enable-key8B switches to 16-byte tuples with int64 keys
(src/types.h:23-29).  As in the JAX package, a 64-bit key travels as two
int32 planes (hi, lo with its sign bit flipped), whose lexicographic order
is the int64 order.  The planes are exactly a (key, payload) pair, so the
pair block sort (K5) and the pair multiway merge (K6) sort 64-bit keys
with no new code, and K7 counts the matches over the planes.

TPU workarounds dropped: S sorted as bitwise-NOT planes and read back to
front (S is sorted ascending like R, so ``recover_s`` has nothing to
recover), ``return_2d``, and the base-2^30 count limbs with their overflow
flag: the count is one int64 on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mergejoin
from . import multiwaymerge as mw
from . import sort as sort_ops
from .bitonic import KEY_NEG_INF

LO_BIAS = np.int32(KEY_NEG_INF)  # xor flips the sign bit: unsigned -> signed


def split64(keys64: np.ndarray):
    """Host-side split of int64 keys into order-preserving int32 planes."""
    keys64 = np.asarray(keys64, np.int64)
    hi = (keys64 >> 32).astype(np.int32)
    lo = (keys64 & 0xFFFFFFFF).astype(np.uint32).astype(np.int64)
    lo_biased = (lo - 2**31).astype(np.int32)
    return hi, lo_biased


def join64(hi: np.ndarray, lo_biased: np.ndarray) -> np.ndarray:
    """Inverse of split64 (host-side)."""
    lo = (lo_biased.astype(np.int64) + 2**31).astype(np.uint64)
    return (hi.astype(np.int64) << 32) | lo.astype(np.int64)


def sort64(hi: torch.Tensor, lo_biased: torch.Tensor, n: int | None = None,
           fanin: int = 16):
    """Sort int64 keys given as planes with the pair multiway sort (K5,
    then K6 levels): lex (hi, lo_biased) == int64 order.  Returns the flat
    padded sorted ``(hi, lo_biased)``; the live prefix is ``[:n]``."""
    return mw.multiway_sort(hi, n, fanin=fanin, payloads=lo_biased)


def widen32(keys: torch.Tensor):
    """Widen int32 keys to order-preserving (hi, lo_biased) planes -- the
    KEY_8B layout of the reference's workloads, whose key values are the
    same under KEY_4B and KEY_8B (types.h:23-29 widens the storage only):
    hi is the sign extension, lo_biased the low word with its sign bit
    flipped."""
    return keys >> 31, keys ^ int(LO_BIAS)


def key8b_join_count(rkeys: torch.Tensor, skeys: torch.Tensor, nR: int,
                     nS: int, fanin: int = 16, pallas_sort: bool = True):
    """End-to-end KEY_8B count join of int32-valued key columns widened to
    64-bit planes.  ``pallas_sort`` keeps the JAX function's flag name:
    True sorts both sides with ``sort64`` and counts with K7; False is the
    forced-scalar analog end to end (``torch.sort`` of the packed int64
    keys and the tagged-sort count, the reference's only working KEY_8B
    path, main.c:871-877).  Returns ``(sorted_r_planes, sorted_s_planes,
    count)``: both sides ascending, the count an int64 0-d tensor (combine
    with :func:`finish_count64`)."""
    rhi, rlo = widen32(rkeys[:nR])
    shi, slo = widen32(skeys[:nS])
    if pallas_sort:
        rhi, rlo = sort64(rhi, rlo, nR, fanin)
        shi, slo = sort64(shi, slo, nS, fanin)
        count = mergejoin.merge_join_count_fused64(rhi, rlo, shi, slo, nR,
                                                   nS)
        return (rhi[:nR], rlo[:nR]), (shi[:nS], slo[:nS]), count
    r64 = torch.sort(sort_ops.pack_pairs(rhi, rlo)).values
    s64 = torch.sort(sort_ops.pack_pairs(shi, slo)).values
    return (sort_ops.unpack_pairs(r64), sort_ops.unpack_pairs(s64),
            merge_join_count_torch64(r64, s64))


def finish_count64(count: torch.Tensor) -> int:
    """The count of :func:`key8b_join_count` as a Python int.  The JAX
    package combines two base-2^30 limbs here; the port's count is already
    an exact int64."""
    return int(count.item())


def merge_join_count_torch64(r64: torch.Tensor,
                             s64: torch.Tensor) -> torch.Tensor:
    """Match count over ascending int64 keys by the tag-sort rank
    reduction (the port of ``merge_join_count_xla64``, the scalar
    merge-join analog of KEY_8B), in int64 so it does not wrap at 2^31.

    A stable sort of R's keys followed by S's orders ties R first, so the
    S keys sorted before an R key are those below it; with S's keys first
    they are those not above it.  The difference summed over R is the
    count.
    """
    nR = r64.numel()

    def s_before_r(s_first: bool) -> torch.Tensor:
        keys = torch.cat([s64, r64] if s_first else [r64, s64])
        src = torch.sort(keys, stable=True).indices
        is_s = src < s64.numel() if s_first else src >= nR
        return torch.cumsum(is_s, 0)[~is_s].sum()

    return s_before_r(True) - s_before_r(False)


def merge_join_count_numpy64(rkeys64: np.ndarray, skeys64: np.ndarray) -> int:
    """NumPy reference oracle: sum_k cntR(k)*cntS(k) over int64 keys."""
    rk, rc = np.unique(rkeys64, return_counts=True)
    sk, sc = np.unique(skeys64, return_counts=True)
    _, ri, si = np.intersect1d(rk, sk, assume_unique=True,
                               return_indices=True)
    return int(np.sum(rc[ri].astype(np.int64) * sc[si].astype(np.int64)))
