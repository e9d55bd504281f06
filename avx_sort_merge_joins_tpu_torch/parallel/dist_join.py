"""Range-partition sort-merge join count over a mesh of shards (counterpart
of ``avx_sort_merge_joins_tpu/parallel/dist_join.py:59-154``; reference:
src/joins/sortmergejoin_multiway.c and joincommon.c).

Per shard, between the mesh's collectives:

  1. the key range over live tuples: min/max per shard, then over the mesh;
  2. partition: range-bucketize the R and S shards by destination shard
     (phase 1 of the reference, sortmergejoin_multiway.c:331-386);
  3. exchange the padded buckets by all-to-all;
  4. count the shard's owned key range with the ``torch.sort`` baseline
     (``merge_join_count_torch``, int64): key ranges are disjoint, so the
     counts sum to the global count.

Pads never join: R pads INT32_MAX, S pads INT32_MIN.  The JAX package
counts in int32 with a float32 magnitude guard and recounts through numpy
when a shard's count nears 2^31 (dist_join.py:40-55,141-151), a TPU
workaround; the port's count is int64 and needs no guard.
"""

from __future__ import annotations

import torch

from ..ops import mergejoin
from . import exchange as ex
from .mesh import Mesh, is_2d

BUCKET_ALIGN = 128  # the JAX package's collective-friendly alignment


def dist_join_count(rkeys, rpayloads, skeys, spayloads, n_r: int, n_s: int,
                    mesh: Mesh, slack: float = 2.0):
    """Equi-join match count of R ⋈ S distributed over ``mesh``.

    Inputs are 1-D global columns (numpy or torch) of logical sizes ``n_r``
    and ``n_s``.  Returns ``(count, overflow)`` as host ints; ``overflow``
    must be 0 for the count to be exact (raise slack otherwise)."""
    if is_2d(mesh):
        raise ValueError(
            "dist_join_count requires a flat mesh; the range exchange "
            "addresses only the chip axis -- use dist_mway_join_count for "
            "2-D ('host','chip') meshes")
    n = mesh.n
    shard_r, shard_s = -(-n_r // n), -(-n_s // n)
    cap_r = ex.bucket_cap(shard_r, n, slack, BUCKET_ALIGN)
    cap_s = ex.bucket_cap(shard_s, n, slack, BUCKET_ALIGN)

    def stage(col, size, shard, fill):
        return mesh.shard(ex.pad_column(col[:size], shard * n, fill,
                                        device=mesh.device).reshape(n, shard))

    rk = stage(rkeys, n_r, shard_r, ex.R_PAD_KEY)
    rp = stage(rpayloads, n_r, shard_r, 0)
    sk = stage(skeys, n_s, shard_s, ex.S_PAD_KEY)
    sp = stage(spayloads, n_s, shard_s, 0)
    nv_r = ex.valid_counts(n_r, shard_r, n)
    nv_s = ex.valid_counts(n_s, shard_s, n)

    # 1. the global key range over live tuples, on every shard's device
    big = 2**31 - 1
    lo, hi = [], []
    for me in range(n):
        dev = mesh.device_of(me)
        live_r = torch.arange(shard_r, device=dev) < int(nv_r[me])
        live_s = torch.arange(shard_s, device=dev) < int(nv_s[me])
        lo.append(torch.minimum(torch.where(live_r, rk[me], big).min(),
                                torch.where(live_s, sk[me], big).min()))
        hi.append(torch.maximum(torch.where(live_r, rk[me], -big).max(),
                                torch.where(live_s, sk[me], -big).max()))
    lo = mesh.replicated(torch.min, mesh.all_gather(
        mesh.stack(x[None] for x in lo)))
    hi = mesh.replicated(torch.max, mesh.all_gather(
        mesh.stack(x[None] for x in hi)))
    # 2. partition by destination shard
    parts, overflow = {}, 0
    for side, k, p, nv, cap, pad in (("r", rk, rp, nv_r, cap_r, ex.R_PAD_KEY),
                                     ("s", sk, sp, nv_s, cap_s,
                                      ex.S_PAD_KEY)):
        cut = [ex.bucketize_by(ex.dest_of_keys(
                   k[me], n, mesh.replica(lo, me), mesh.replica(hi, me)),
                   k[me], p[me], int(nv[me]), n, cap, pad)
               for me in range(n)]
        # 3. all-to-all of the padded buckets
        parts[side] = ex.exchange(mesh, *(mesh.stack(c[i] for c in cut)
                                          for i in range(3)))
        overflow += mesh.host_sum(c[3] for c in cut)
    # 4. count over each shard's owned key range
    grk, gsk = parts["r"][0], parts["s"][0]
    count = mesh.host_sum(mergejoin.merge_join_count_torch(
        grk[me], gsk[me], grk[me].numel(), gsk[me].numel())
        for me in range(n))
    return count, overflow
