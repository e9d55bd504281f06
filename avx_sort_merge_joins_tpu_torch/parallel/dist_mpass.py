"""Distributed m-pass count join over a mesh of shards (counterpart of
``avx_sort_merge_joins_tpu/parallel/dist_mpass.py``; reference:
src/joins/sortmergejoin_multipass.c, whose phase 3.1 merges pairs of remote
runs while pulling them to the local NUMA node (:410-619) and whose phase
3.2 runs log(numruns) local two-way merge passes (:621-708)).

Per shard, SPMD-style with an explicit ``me`` between the mesh's
collectives, as ``dist_mway`` does:

  sort       -- the shard's keys sorted by the multiway sort (K1 + K2);
  exchange   -- ``dist_mway``'s equi-depth splitters and contiguous
                buckets, delivered by one all-to-all (in two stages on a
                2-D mesh): each shard receives n ascending runs of its
                owned key range;
  merge      -- log2(n) pairwise merge passes over the received runs: the
                varlen K4 at twice the stride each pass, a run count that
                is not a power of two padded with empty runs; the data is
                re-read once a pass, the m-pass trade against m-way's one
                k-way pass.  With ``overlap=True`` the buckets arrive in
                permute rounds and each pair of arrivals is merged as soon
                as both are in, then the halving passes follow;
  mergejoin  -- K3 per shard over its owned key range, in int64; the count
                is the host sum over shards.

``use_kernels=False`` is the ``torch.sort`` baseline route (the JAX
package's ``use_pallas=False``): the local sorts and the merge of the
received runs are ``torch.sort``.  On a mesh on the CPU every kernel takes
its plain version; on the card it launches or raises.

TPU workarounds dropped: the alternating run directions (the JAX passes
after the first read the kernel's descending output runs, ``b_asc`` only on
the first pass; every run here is ascending, so every pass is the same
varlen merge), the ``(rows, 128)`` layouts and spare tile rows, and the
base-2^30 count limbs with ``CountLimbOverflow``: the JAX path raises on a
hot key whose cntR * cntS reaches 2^29 on one shard, the port counts in
int64 and stays exact.
"""

from __future__ import annotations

import torch

from ..ops import sort as sort_ops
from ..params import BLOCKSIZE_DEFAULT
from ..utils.log import warn
from .dist_mway import (FANIN_DEFAULT, _arrivals, _count_owned, _cut_all,
                        _equidepth_bounds, _local_sorted, _pad_runs,
                        _pow2_runs, _receive, _row_sums, _shape, _stage)
from .mesh import Mesh, host_shape, is_2d


def _halving_passes(keys: torch.Tensor, lens: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """Varlen K4 passes, each at twice the stride of the one before, until
    one run is left (the reference's ping-ponged halving loop,
    sortmergejoin_multipass.c:634-656).  ``keys`` holds exactly
    ``lens.numel() * stride`` slots, ``lens.numel()`` a power of two."""
    while lens.numel() > 1:
        keys, _, lens = sort_ops.merge_pass(keys, None, lens=lens,
                                            stride=stride)
        stride *= 2
    return keys


def _pairwise_merge_received(recv: torch.Tensor, counts: torch.Tensor,
                             n: int, cap: int,
                             use_kernels: bool) -> torch.Tensor:
    """One shard's n received ascending runs (run s at ``[s*cap, s*cap +
    counts[s])``) merged into one column by log2 pairwise passes, the run
    count padded to a power of two with empty runs; ``torch.sort`` on the
    baseline route.  The live prefix is ``counts.sum()``."""
    if not use_kernels:
        return torch.sort(recv).values
    nruns = _pow2_runs(n)
    keys, lens, _ = _pad_runs(recv, counts, n, cap, nruns)
    return _halving_passes(keys, lens, cap)


def _overlap_receive_merge(mesh: Mesh, bflat, counts, cap: int):
    """Permute-round delivery with merge-as-they-arrive: round t brings
    each shard the bucket of shard (me - t), and every second arrival is
    merged with the one before by the varlen K4 on two runs, before the
    next round's permute; the halving passes then take the n / 2 merged
    runs.  Returns the merged column of each shard and each shard's live
    total."""
    n = mesh.n
    runs = [[] for _ in range(n)]
    lens = [[] for _ in range(n)]
    prev = None
    for t, (piece, cnt) in enumerate(_arrivals(mesh, bflat, counts, cap)):
        if t % 2 == 0:
            prev = (piece, cnt)
            continue
        for me in range(n):
            out, _, ln = sort_ops.merge_pass(
                torch.cat([prev[0][me], piece[me]]), None,
                lens=torch.stack([prev[1][me], cnt[me]]), stride=cap)
            runs[me].append(out)
            lens[me].append(ln)
    merged = [_halving_passes(torch.cat(runs[me]), torch.cat(lens[me]),
                              2 * cap) for me in range(n)]
    return merged, _row_sums(mesh, mesh.all_to_all(counts))


def _join(rkeys, skeys, n_r: int, n_s: int, mesh: Mesh, slack: float,
          block: int, fanin: int | None, use_kernels: bool, overlap_ok: bool):
    """One run of the pipeline at one slack: ``(count, overflow)``."""
    n = mesh.n
    hier = host_shape(mesh) if is_2d(mesh) else None
    shard_r, cap_r, nv_r = _shape(n_r, n, slack)
    shard_s, cap_s, nv_s = _shape(n_s, n, slack)
    rk = _stage(rkeys, n_r, shard_r, mesh, False)
    sk = _stage(skeys, n_s, shard_s, mesh, False)
    r_sorted = [_local_sorted(rk[me], block, fanin, use_kernels)
                for me in range(n)]
    s_sorted = [_local_sorted(sk[me], block, fanin, use_kernels)
                for me in range(n)]
    del rk, sk
    bounds = _equidepth_bounds(mesh, r_sorted, s_sorted, nv_r, nv_s)
    merged, totals, overflow = {}, {}, 0
    for side, ks, nv, cap in (("r", r_sorted, nv_r, cap_r),
                              ("s", s_sorted, nv_s, cap_s)):
        bflat, _, counts, ov = _cut_all(mesh, ks, nv, bounds, cap)
        overflow += ov
        if overlap_ok:
            merged[side], totals[side] = _overlap_receive_merge(
                mesh, bflat, counts, cap)
            continue
        recv, rcounts = _receive(mesh, bflat, counts, cap, hier=hier)
        del bflat
        totals[side] = _row_sums(mesh, rcounts)
        merged[side] = [_pairwise_merge_received(recv[me], rcounts[me], n,
                                                 cap, use_kernels)
                        for me in range(n)]
        del recv
    count = _count_owned(mesh, merged["r"], merged["s"], totals["r"],
                         totals["s"])
    return count, overflow


def dist_mpass_join_count(rkeys, skeys, n_r: int, n_s: int, mesh: Mesh,
                          slack: float = 2.0, block: int = BLOCKSIZE_DEFAULT,
                          fanin: int | None = FANIN_DEFAULT,
                          use_kernels: bool = True, overlap: bool = False):
    """Distributed m-pass equi-join match count over ``mesh``.

    Returns (count, overflow) as host ints; overflow must be 0.  A bucket
    overflow doubles the slack and retries, up to 16, as the JAX package
    does; past that it is returned.  ``rkeys``/``skeys`` are 1-D key
    columns (numpy or torch, anywhere) of logical sizes ``n_r``/``n_s``;
    ``fanin`` is the local multiway sort's.  A 2-D mesh (``make_mesh2d``)
    exchanges in two stages.

    ``overlap=True`` delivers the buckets in permute rounds and merges each
    pair of arrivals while the next round circulates (the reference's
    first NUMA-merge phase).  It needs the kernel pipeline, a flat mesh and
    a power-of-two shard count > 1; otherwise it warns and runs the bulk
    path, as the JAX package does.
    """
    n = mesh.n
    hier = host_shape(mesh) if is_2d(mesh) else None
    overlap_ok = (overlap and use_kernels and n > 1 and n & (n - 1) == 0
                  and hier is None)
    if overlap and not overlap_ok:
        warn("dist m-pass overlap=True requires the kernel pipeline, a "
             "power-of-two shard count, and a flat mesh "
             f"(use_kernels={use_kernels}, n_chips={n}, "
             f"mesh_axes={mesh.axis_names}); running the non-overlapped "
             "all_to_all path")
    while True:
        count, ov = _join(rkeys, skeys, n_r, n_s, mesh, slack, block, fanin,
                          use_kernels, overlap_ok)
        if ov == 0 or slack >= 16.0:
            return count, ov
        # extreme skew overflowed a bucket: retry with doubled capacity
        slack *= 2
