"""Radix partitioning: partition ids, the histogram kernel K8 and the
padded partition layout (counterpart of
``avx_sort_merge_joins_tpu/ops/partition.py``; reference:
src/partition/partition.c).

* ``hash_bit_modulo`` / ``partition_ids``: ``((K - 1) & MASK) >> NBITS``
  (partition.c:29, note the K-1 bias), a logical shift.
* ``radix_hist``: per-tile counts of the ids, ``(ntiles, fanout)`` int32
  for tiles of ``HIST_TILE`` keys (K8, ``csrc/radix_hist.cu``);
  ``radix_hist_any``: the global ``(fanout,)`` histogram from the same
  kernel.  On a CPU tensor both take the plain version
  ``radix_hist_plain``.  One kernel covers fanouts 2^1..2^16: the JAX
  package's lane-rotation kernel stops at 2^7 and hands larger fanouts to
  an MXU matmul, which the port keeps only as ``radix_hist_mxu``.
* ``radix_hist_torch``: a scatter-add, the counterpart of
  ``radix_hist_xla`` and the library yardstick.
* ``partition_relation``: the padded, aligned partition layout, in plain
  torch ops (a stable sort on the id and a scatter, as the JAX function is
  no Pallas kernel), with ``sizes`` from K8 on the card;
  ``radix_cluster_numpy``: the numpy oracle.

The joins never partition physically: the block sort and multiway merge
take that role on one device.  This module serves the partitioning
micro-benchmark (``bench/partitioningbench.py``).

TPU workarounds dropped: the ``(rows, 128)`` key tiles (keys are one flat
column, and the last tile may be ragged) and the 8-row output blocks of
which every 8th row was read.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels import _build
from . import mxu_permute
from . import sort as sort_ops

HIST_TILE = 65536  # keys per histogram tile: the JAX package's 512 x 128
MAX_RADIX_BITS = 16  # the reference bench's largest fanout, 2^16
ALIGN_DEFAULT = 128  # partition starts: one 128-lane row, as in JAX
MAX_PARTITION_N = 64_000_000  # partition_relation's input limit


def hash_bit_modulo(keys: torch.Tensor, mask: int, nbits: int) -> torch.Tensor:
    """((K-1) & MASK) >> NBITS (partition.c:29) as int32.  K-1 wraps as in
    int32 and the shift is logical: with MASK below 2^31, masking the
    int64 K-1 keeps the same bits."""
    if not 0 <= mask < 2**31 or nbits < 0:
        raise ValueError(f"mask {mask:#x} and shift {nbits}: the mask must "
                         "fit a non-negative int32 and the shift be >= 0")
    return (((keys.to(torch.int64) - 1) & mask) >> nbits).to(torch.int32)


def check_radix(nradixbits: int, bitshift: int) -> None:
    """Raise ValueError unless 1 <= nradixbits <= 16, bitshift >= 0 and
    nradixbits + bitshift <= 31 (the mask must fit an int32; the JAX
    package raises OverflowError past that)."""
    if not 1 <= nradixbits <= MAX_RADIX_BITS:
        raise ValueError(f"nradixbits {nradixbits} outside "
                         f"[1, {MAX_RADIX_BITS}]")
    if bitshift < 0 or nradixbits + bitshift > 31:
        raise ValueError(f"nradixbits {nradixbits} + bitshift {bitshift} "
                         "is past bit 31: the mask does not fit an int32")


def partition_ids(keys: torch.Tensor, nradixbits: int,
                  bitshift: int = 0) -> torch.Tensor:
    """Partition id of each key for fanout 2**nradixbits starting at bit
    ``bitshift`` (sortmergejoin_multiway.c:372-376)."""
    check_radix(nradixbits, bitshift)
    mask = ((1 << nradixbits) - 1) << bitshift
    return hash_bit_modulo(keys, mask, bitshift)


# --------------------------------------------------------------------------
# K8: the histogram
# --------------------------------------------------------------------------

def radix_hist_plain(keys: torch.Tensor, nradixbits: int,
                     bitshift: int = 0) -> torch.Tensor:
    """Plain version of K8: one ``torch.bincount`` of tile * fanout + id,
    shaped ``(ntiles, fanout)``."""
    fanout = 1 << nradixbits
    pid = partition_ids(keys, nradixbits, bitshift).to(torch.int64)
    n = pid.numel()
    ntiles = sort_ops.cdiv(n, HIST_TILE)
    tile = torch.arange(n, device=keys.device) // HIST_TILE
    return torch.bincount(tile * fanout + pid, minlength=ntiles * fanout
                          ).to(torch.int32).view(ntiles, fanout)


def _hist(keys: torch.Tensor, nradixbits: int, bitshift: int,
          per_tile: bool, name: str) -> torch.Tensor:
    check_radix(nradixbits, bitshift)
    sort_ops._check_keys(keys, keys.numel(), name)
    n = keys.numel()
    if n >= 2**31:
        raise ValueError(f"{name}: {n} keys, the counts are int32")
    if keys.device.type == "cpu":
        hist = radix_hist_plain(keys, nradixbits, bitshift)
        return hist if per_tile else hist.sum(0, dtype=torch.int32)
    fanout = 1 << nradixbits
    shape = (sort_ops.cdiv(n, HIST_TILE), fanout) if per_tile else (fanout,)
    out = (torch.empty if per_tile else torch.zeros)(
        shape, dtype=torch.int32, device=keys.device)
    if n == 0:
        return out
    _build.launch("K8", "smj_radix_hist", keys, keys.data_ptr(), n,
                  nradixbits, bitshift, int(per_tile), out.data_ptr())
    return out


def radix_hist(keys: torch.Tensor, nradixbits: int,
               bitshift: int = 0) -> torch.Tensor:
    """Per-tile histogram of the partition ids of the flat int32 column
    ``keys``: ``(cdiv(n, HIST_TILE), fanout)`` int32, row t counting keys
    ``[t * HIST_TILE, (t + 1) * HIST_TILE)`` (sum along axis 0 for the
    global histogram; the per-tile rows give per-chunk scatter offsets,
    partition.c:99-117).  The last tile may be ragged."""
    return _hist(keys, nradixbits, bitshift, True, "radix_hist")


def radix_hist_any(keys: torch.Tensor, nradixbits: int,
                   bitshift: int = 0) -> torch.Tensor:
    """Global ``(fanout,)`` int32 histogram at any fanout 2^1..2^16, from
    K8 writing one row."""
    return _hist(keys, nradixbits, bitshift, False, "radix_hist_any")


def radix_hist_torch(keys: torch.Tensor, nradixbits: int,
                     bitshift: int = 0) -> torch.Tensor:
    """One-pass scatter-add histogram, ``(fanout,)`` int32: the
    counterpart of ``radix_hist_xla``, the check and library yardstick."""
    pid = partition_ids(keys, nradixbits, bitshift).reshape(-1)
    return torch.zeros(1 << nradixbits, dtype=torch.int32,
                       device=keys.device).scatter_add_(
        0, pid.to(torch.int64), torch.ones_like(pid))


def radix_hist_mxu(keys: torch.Tensor, nradixbits: int,
                   bitshift: int = 0) -> torch.Tensor:
    """The ``(fanout,)`` histogram through ``mxu_permute.onehot_hist``, the
    JAX package's high-fanout form (a one-hot matmul on the MXU there, a
    plain histogram here)."""
    pid = partition_ids(keys, nradixbits, bitshift)
    return mxu_permute.onehot_hist(pid, 1 << nradixbits)


# --------------------------------------------------------------------------
# full partition
# --------------------------------------------------------------------------

def partition_relation(keys: torch.Tensor, payloads: torch.Tensor,
                       nradixbits: int, bitshift: int = 0,
                       align: int = ALIGN_DEFAULT):
    """Partition a column pair into fanout contiguous, padded partitions.

    Returns ``(pkeys, ppayloads, offsets, sizes)``: partition p occupies
    ``pkeys[offsets[p] : offsets[p] + sizes[p]]`` in input order (a stable
    grouping); starts are aligned to ``align`` tuples with zeros between
    partitions (partition.c:329-354).  The output holds the worst case,
    ``n + fanout * align`` slots.  ``sizes`` is K8's global histogram.

    The grouping is one stable sort on the id and a scatter, which read
    and write every tuple at random: ``n`` is limited to
    ``MAX_PARTITION_N`` so that no join pipeline routes through it.
    """
    sort_ops._check_keys(keys, keys.numel(), "partition_relation")
    sort_ops._check_payloads(keys, payloads, 0, "partition_relation")
    n = keys.numel()
    if n > MAX_PARTITION_N:
        raise ValueError(f"partition_relation: {n} tuples, more than "
                         f"{MAX_PARTITION_N}: it is a scatter and serves the "
                         "partitioning bench and small inputs only")
    if align < 1:
        raise ValueError(f"partition_relation: align {align} < 1")
    fanout = 1 << nradixbits
    pid = partition_ids(keys, nradixbits, bitshift).to(torch.int64)
    spid, order = torch.sort(pid, stable=True)
    sizes = radix_hist_any(keys, nradixbits, bitshift)
    sizes64 = sizes.to(torch.int64)
    padded = (sizes64 + align - 1) // align * align
    offsets = torch.cumsum(padded, 0) - padded
    start = torch.cumsum(sizes64, 0) - sizes64
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    target = offsets[spid] + (idx - start[spid])
    cap = n + fanout * align
    pk = torch.zeros(cap, dtype=keys.dtype, device=keys.device)
    pp = torch.zeros(cap, dtype=payloads.dtype, device=keys.device)
    pk[target] = keys[order]
    pp[target] = payloads[order]
    return pk, pp, offsets.to(torch.int32), sizes


def partition_live(pkeys: torch.Tensor, ppayloads: torch.Tensor,
                   offsets: torch.Tensor, sizes: torch.Tensor):
    """The live slices ``[offsets[p], offsets[p] + sizes[p])`` of a
    :func:`partition_relation` output, concatenated in partition order:
    what :func:`radix_cluster_numpy` returns for the same input."""
    sizes64 = sizes.to(torch.int64)
    start = torch.cumsum(sizes64, 0) - sizes64
    n = int(sizes64.sum())
    idx = torch.repeat_interleave(offsets.to(torch.int64) - start, sizes64,
                                  output_size=n)
    idx += torch.arange(n, dtype=torch.int64, device=idx.device)
    return pkeys[idx], ppayloads[idx]


def radix_cluster_numpy(keys: np.ndarray, payloads: np.ndarray,
                        nradixbits: int, bitshift: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NumPy oracle of the naive radix_cluster (partition.c:93-149):
    contiguous unpadded partitions in id order, stable within partitions.
    Returns (keys, payloads, sizes)."""
    fanout = 1 << nradixbits
    mask = (fanout - 1) << bitshift
    pid = (((keys.astype(np.int64) - 1) & mask) >> bitshift).astype(np.int64)
    order = np.argsort(pid, kind="stable")
    sizes = np.bincount(pid, minlength=fanout).astype(np.int32)
    return keys[order], payloads[order], sizes
