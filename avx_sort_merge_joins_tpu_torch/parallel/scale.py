"""Workload-A scale tier: 1.6B ⋈ 1.6B without a full-size relation on
the host (counterpart of ``avx_sort_merge_joins_tpu/parallel/scale.py``;
reference: scripts/tput-scalability.sh:15-16, the R = S = 1.6·10⁹
workload).

Each shard's columns are made on its device, one shard at a time, and go
to the distributed m-way join through its ``pre_sharded`` input
(``parallel/dist_mway.py``).  The host holds scalars and, under skew, the
quantile table of the Zipf CDF (2^20 entries).

Workload semantics (main.c:534-588): R is unique and S a foreign key over
it.  The reference builds R by a global Knuth shuffle of 1..|R|; this tier
gives shard i the strided key set {i+1, i+1+P, i+1+2P, ...} (P = the shard
count), which is unique over the mesh and as range-uniform per shard as a
shuffle, so the exchange volume and the splitters behave as on the
shuffled workload.  |R| and |S| must divide by the shard count
(1.6·10⁹ % 8 == 0).

S differs from the JAX package's.  The JAX tier draws each shard's S with
threefry (``jax.random.randint(fold_in(PRNGKey(s_seed), me), ...)``); the
port draws it from a ``torch.Generator`` on the shard's device, seeded from
``(s_seed, me)``.  R is the same array in both packages; the S arrays are
not, and the counts agree (both are |S|: every foreign key matches one
unique R key).  A generator seeded alike gives different streams on the
CPU and on the card, so the same call gives different S on the two.

int32 at 1.6B: keys, shard sizes (200,000,000) and the strided keys
``me + 1 + P * j`` stay below 2^31; the count is int64.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops.multiwaymerge import FANIN_DEFAULT
from ..utils.log import info
from .mesh import Mesh, make_mesh

ZIPF_QUANTILE_BINS = 1 << 20
_LUT_CHUNK = 1 << 24  # harmonic terms a numpy pass


def _zipf_quantile_lut(n: int, z: float, bins: int = ZIPF_QUANTILE_BINS
                       ) -> np.ndarray:
    """Host-side quantile table of the Zipf(z) CDF over keys 1..n: entry q
    holds the smallest key whose cumulative probability reaches (q+1)/bins
    (int64, at most n).  Two streamed passes over the harmonic terms in
    chunks of 2^24: O(n) flops, O(bins) memory, so it scales to alphabets
    of 1.6·10⁹ where the reference's per-key table (genzipf.c:60-92) could
    not exist.  The JAX function's arithmetic, bit for bit; its loop over
    quantiles is one vectorised search a chunk, with the same float64
    targets ``(q + 1) / bins * total``."""
    lut = np.empty(bins, np.int64)
    total = 0.0
    for lo in range(1, n + 1, _LUT_CHUNK):
        hi = min(n + 1, lo + _LUT_CHUNK)
        total += np.sum(1.0 / np.arange(lo, hi, dtype=np.float64) ** z)
    acc = 0.0
    q = 0
    for lo in range(1, n + 1, _LUT_CHUNK):
        hi = min(n + 1, lo + _LUT_CHUNK)
        cs = acc + np.cumsum(1.0 / np.arange(lo, hi, dtype=np.float64) ** z)
        acc = cs[-1]
        if q == bins:
            continue
        target = (np.arange(q, bins, dtype=np.int64) + 1) / bins * total
        # targets rise with q: the ones this chunk reaches are a prefix
        take = int(np.searchsorted(target, cs[-1], side="right"))
        lut[q:q + take] = lo + np.searchsorted(cs, target[:take])
        q += take
    lut[q:] = n
    return np.minimum(lut, n)


def _shard_seed(s_seed: int, me: int) -> int:
    """The seed of shard ``me``'s S generator: both numbers mixed by
    numpy's SeedSequence (the counterpart of ``fold_in(PRNGKey(s_seed),
    me)``)."""
    return int(np.random.SeedSequence([s_seed % 2**64, me])
               .generate_state(1, np.uint32)[0])


def make_workload_a_sharded(n_r: int, n_s: int, mesh: Mesh, seed: int = 42,
                            skew: float = 0.0,
                            s_seed: Optional[int] = None):
    """Per-shard generation of the pk-fk workload, each shard on its
    device: uniform foreign keys, or Zipf(z = ``skew``) ones drawn through
    :func:`_zipf_quantile_lut`.

    Returns ``(rk, sk)``, per-shard values of the mesh of ``(shard,)``
    int32 rows (``(mesh.n, shard)`` tensors on a one-device mesh), for
    ``dist_mway_join_count(..., pre_sharded=True)``.
    R is ``me + 1 + n * j`` (no randomness, the JAX arrays exactly); S
    follows ``s_seed`` (``-y``), or ``seed`` when it is None, as the
    reference seeds its relations apart."""
    n = mesh.n
    if n_r % n or n_s % n:
        raise ValueError(f"scale tier: sizes {n_r} and {n_s} must divide by "
                         f"the shard count {n}")
    shard_r, shard_s = n_r // n, n_s // n
    if s_seed is None:
        s_seed = seed
    lut = None
    if skew > 0:
        t0 = time.perf_counter()
        lut = torch.from_numpy(_zipf_quantile_lut(n_r, skew).astype(
            np.int32))
        info(f"Zipf quantile table of {n_r} keys, z={skew}: "
             f"{time.perf_counter() - t0:.3f} s on the host")
    rk = mesh.empty((shard_r,))
    sk = mesh.empty((shard_s,))
    j, luts = {}, {}  # a copy a device
    for me in range(n):
        dev = mesh.device_of(me)
        if dev not in j:
            j[dev] = torch.arange(shard_r, dtype=torch.int32,
                                  device=dev) * n
            luts[dev] = None if lut is None else lut.to(dev)
        torch.add(j[dev], me + 1, out=rk[me])
        gen = torch.Generator(device=dev).manual_seed(_shard_seed(s_seed, me))
        if lut is None:
            torch.randint(1, n_r + 1, (shard_s,), generator=gen,
                          dtype=torch.int32, device=dev, out=sk[me])
        else:
            u = torch.randint(0, ZIPF_QUANTILE_BINS, (shard_s,),
                              generator=gen, dtype=torch.int32, device=dev)
            torch.index_select(luts[dev], 0, u, out=sk[me])
            del u
    return rk, sk


def join_sharded(rk, sk, n_r: int, n_s: int, mesh: Mesh,
                 use_kernels: bool = True,
                 fanin: int | None = FANIN_DEFAULT,
                 slack: float = 2.0, phased: bool = False):
    """The distributed m-way count join of :func:`make_workload_a_sharded`'s
    columns: ``(count, overflow)``, or ``(count, overflow, phases)`` with
    ``phased=True``."""
    from . import dist_mway

    join = (dist_mway.dist_mway_join_phased if phased
            else dist_mway.dist_mway_join_count)
    return join(rk, sk, n_r, n_s, mesh, fanin=fanin, use_kernels=use_kernels,
                pre_sharded=True, slack=slack)


def workload_a_join_count(n_r: int, n_s: int, mesh: Optional[Mesh] = None,
                          seed: int = 42, use_kernels: bool = True,
                          fanin: int | None = FANIN_DEFAULT,
                          skew: float = 0.0,
                          slack: float = 2.0, s_seed: Optional[int] = None,
                          phased: bool = False):
    """The workload-A m-way count join: per-shard generation on the
    device, then the distributed m-way join of the pre-sharded columns.
    Returns ``(count, overflow)``, or ``(count, overflow, phases)`` with
    ``phased=True`` (``dist_mway_join_phased``: sort / merge1 / mergejoin
    / total seconds, the [RECORD] row's columns).  The count must equal
    |S|.  The default mesh is 8 shards of the card."""
    mesh = mesh or make_mesh(8)
    rk, sk = make_workload_a_sharded(n_r, n_s, mesh, seed, skew,
                                     s_seed=s_seed)
    return join_sharded(rk, sk, n_r, n_s, mesh, use_kernels, fanin, slack,
                        phased)
