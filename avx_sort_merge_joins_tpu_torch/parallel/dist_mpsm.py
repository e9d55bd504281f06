"""Distributed MPSM count join over a mesh of shards (counterpart of
``avx_sort_merge_joins_tpu/parallel/dist_mpsm.py``; Albutiu et al.,
PVLDB'12).

MPSM's asymmetry: R is range-partitioned across the shards, S is only
sorted locally and never repartitioned; every shard scans every shard's S
run for its own key range.  Per shard, SPMD-style with an explicit ``me``
between the mesh's collectives, as ``dist_mway`` does:

  sort       -- both relations' shards sorted by the multiway sort (K1 +
                K2);
  exchange   -- R alone goes through ``dist_mway``'s equi-depth splitters
                (sampled from both relations) and contiguous buckets, by
                one all-to-all: shard d receives n ascending R runs of its
                range ``[bounds[d], bounds[d+1])``, the last shard's upper
                end 2^31 - 1, exclusive;
  ring       -- the sorted S runs go around the ring in n rounds of
                ``mesh.ppermute``; in each round every shard counts each of
                its n received R runs against the contiguous slice of the
                passing S run that lies in its range (K3: n^2 launches a
                round, n^3 in all).  The counts are additive over R runs,
                so R is never merged.

K3 takes host lengths: the received R counts are read once, and each
round's S slices, (start, end) for every shard together, come from one
``torch.searchsorted`` on the card and one read.

``use_kernels=False`` is the ``torch.sort`` baseline route (the JAX
package's ``use_pallas=False``): the local sorts are ``torch.sort``; the
count is K3 on both routes, as in the JAX package.  On a mesh on the CPU
every kernel takes its plain version; on the card it launches or raises.

TPU workarounds dropped: the ``(rows, 128)`` layouts and spare tile rows,
the masked rank sums that find the S slice (a search here), the
``fori_loop`` over the R runs, and the base-2^30 count limbs with
``CountLimbOverflow``: the JAX path raises on a hot key whose cntR * cntS
reaches 2^29 on one shard, the port counts in int64 and stays exact.
"""

from __future__ import annotations

import torch

from ..ops import mergejoin
from ..params import BLOCKSIZE_DEFAULT
from .dist_mway import (FANIN_DEFAULT, _cut_all, _equidepth_bounds,
                        _local_sorted, _receive, _shape, _stage)
from .mesh import Mesh, is_2d

RANGE_END = 2**31 - 1  # the last shard's exclusive upper end


def _ranges(bounds: torch.Tensor) -> torch.Tensor:
    """``(n, 2)``: shard d's key range ``[bounds[d], bounds[d+1])``."""
    return torch.stack([bounds, torch.cat([bounds[1:], torch.full(
        (1,), RANGE_END, dtype=bounds.dtype, device=bounds.device)])], 1)


def _ring_count(mesh: Mesh, recv, rlens: list, cap: int, s_cur, s_cnt,
                bounds) -> int:
    """The n rounds of the S ring: in round t shard d holds the sorted S
    run of shard (d - t) and counts each of its received R runs against
    that run's keys in ``[bounds[d], bounds[d+1])``.  ``s_cur`` holds the
    sorted S runs, ``(L,)`` a shard (pads INT32_MAX after the live
    ``s_cnt``), ``rlens[d][s]`` the host length of shard d's R run from
    shard s.  Returns the sum of every K3 call's int64 count."""
    n = mesh.n
    ranges = mesh.own_rows(mesh.replicated(_ranges, bounds))
    perm = [(x, (x + 1) % n) for x in range(n)]
    counts = []
    for rnd in range(n):
        # the slice of each passing run in its holder's range: keys below
        # the range's ends, within the live prefix (a key equal to a bound
        # lies on exactly one shard: lower end inclusive, upper exclusive)
        ends = mesh.map(lambda s, r, c: torch.minimum(
            torch.searchsorted(s, r), c.unsqueeze(-1).to(torch.int64)),
            s_cur, ranges, s_cnt)
        for d, (lo, hi) in enumerate(mesh.tolist(ends)):
            s_col = s_cur[d][lo:]
            for src in range(n):
                counts.append(mergejoin.merge_join_count_fused(
                    recv[d][src * cap:(src + 1) * cap], s_col,
                    rlens[d][src], hi - lo))
        if rnd != n - 1:
            s_cur = mesh.ppermute(s_cur, perm)
            s_cnt = mesh.ppermute(s_cnt, perm)
    return mesh.host_sum(counts)


def _join(rkeys, skeys, n_r: int, n_s: int, mesh: Mesh, slack: float,
          block: int, fanin: int | None, use_kernels: bool):
    """One run of the pipeline at one slack: ``(count, overflow)``."""
    n = mesh.n
    shard_r, cap_r, nv_r = _shape(n_r, n, slack)
    shard_s, _, nv_s = _shape(n_s, n, slack)
    rk = _stage(rkeys, n_r, shard_r, mesh, False)
    sk = _stage(skeys, n_s, shard_s, mesh, False)
    r_sorted = [_local_sorted(rk[me], block, fanin, use_kernels)
                for me in range(n)]
    s_sorted = [_local_sorted(sk[me], block, fanin, use_kernels)
                for me in range(n)]
    del rk, sk
    bounds = _equidepth_bounds(mesh, r_sorted, s_sorted, nv_r, nv_s)
    bflat, _, counts, overflow = _cut_all(mesh, r_sorted, nv_r, bounds,
                                          cap_r)
    recv, rcounts = _receive(mesh, bflat, counts, cap_r)
    del bflat
    s_cur = mesh.stack(s_sorted)
    del s_sorted
    s_cnt = mesh.shard(torch.as_tensor(nv_s))
    count = _ring_count(mesh, recv, mesh.tolist(rcounts), cap_r, s_cur,
                        s_cnt, bounds)
    return count, overflow


def dist_mpsm_join_count(rkeys, skeys, n_r: int, n_s: int, mesh: Mesh,
                         slack: float = 2.0, block: int = BLOCKSIZE_DEFAULT,
                         fanin: int | None = FANIN_DEFAULT,
                         use_kernels: bool = True):
    """MPSM equi-join match count over a flat ``mesh``.

    Returns (count, overflow) as host ints; overflow (R's buckets; S never
    moves through buckets) must be 0.  A bucket overflow doubles the slack
    and retries, up to 16, as the JAX package does.  ``rkeys``/``skeys``
    are 1-D key columns (numpy or torch, anywhere) of logical sizes
    ``n_r``/``n_s``; ``fanin`` is the local multiway sort's.  A 2-D mesh
    raises ``ValueError``: the S ring and R's exchange address only the
    flat shard axis.
    """
    if is_2d(mesh):
        raise ValueError(
            "dist_mpsm_join_count requires a flat mesh (the S ring and R "
            "range exchange address only the chip axis)")
    while True:
        count, ov = _join(rkeys, skeys, n_r, n_s, mesh, slack, block, fanin,
                          use_kernels)
        if ov == 0 or slack >= 16.0:
            return count, ov
        # extreme skew overflowed a bucket: retry with doubled capacity
        slack *= 2
