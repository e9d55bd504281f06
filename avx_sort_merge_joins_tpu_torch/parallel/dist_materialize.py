"""Distributed materializing join over a mesh of shards (counterpart of
``avx_sort_merge_joins_tpu/parallel/dist_materialize.py:61-221``;
reference: src/joins/joincommon.c:266-289 under JOIN_MATERIALIZE, whose
threads emit the matching S tuple once per match pair).

The distributed m-way pipeline with S's payloads riding along; per shard,
SPMD-style with an explicit ``me`` between the mesh's collectives:

  sort       -- R keys only by the multiway sort (K1 + K2): the output is
                <S-key, S-payload>, so R's payloads never travel; S as
                (key, payload) pairs by the multiway sort with payloads
                (K5 + K6);
  exchange   -- ``dist_mway``'s equi-depth splitters and contiguous
                buckets, both S columns cut at the same ranks; one
                all-to-all a column (two stages on a 2-D mesh);
  merge      -- the received R runs by the varlen K2, the received S pairs
                by the varlen K6;
  output     -- per shard ``materialize_matches`` over the live prefixes,
                then ``expand_matches`` where an R key repeats (one row
                per match pair); shards own disjoint key ranges, so their
                outputs, concatenated in shard order, are the join's rows.

``use_kernels=False`` is the ``torch.sort`` baseline route (the JAX
package's ``use_pallas=False``).  On a mesh on the CPU every kernel takes
its plain version; on the card it launches or raises.

TPU workarounds dropped: the static output capacity ``cap_out``, its
``out_slack`` and the output overflow (XLA needs static shapes; the port's
``expand_matches`` returns the exact rows), and the sentinel repair of the
merged columns past their live prefixes (the port passes the live lengths
to ``materialize_matches``, which reads nothing past them).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import materialize as mat
from ..params import BLOCKSIZE_DEFAULT
from .dist_mway import (FANIN_DEFAULT, _check_fanin, _cut_all,
                        _equidepth_bounds, _exchange, _local_sorted,
                        _local_sorted_pair, _merge_received,
                        _merge_received_pair, _receive, _row_sums, _shape,
                        _stage)
from .mesh import Mesh, host_shape, is_2d

# retries taken by the most recent dist_join_materialize call (0: the
# equi-depth splitters balanced the workload on the first attempt)
LAST_RETRIES = 0


def _join(rkeys, skeys, spayloads, n_r: int, n_s: int, mesh: Mesh,
          slack: float, block: int, fanin: int | None, use_kernels: bool):
    """One run of the pipeline at one slack: ``(rows, overflow)``, rows
    the ``(keys, payloads)`` output columns of each shard."""
    n = mesh.n
    hier = host_shape(mesh) if is_2d(mesh) else None
    shard_r, cap_r, nv_r = _shape(n_r, n, slack)
    shard_s, cap_s, nv_s = _shape(n_s, n, slack)
    rk = _stage(rkeys, n_r, shard_r, mesh, False)
    sk = _stage(skeys, n_s, shard_s, mesh, False)
    sp = _stage(spayloads, n_s, shard_s, mesh, False)
    r_sorted = [_local_sorted(rk[me], block, fanin, use_kernels)
                for me in range(n)]
    s_pairs = [_local_sorted_pair(sk[me], sp[me], block, fanin, use_kernels)
               for me in range(n)]
    del rk, sk, sp
    s_keys = [p[0] for p in s_pairs]
    s_pays = [p[1] for p in s_pairs]
    del s_pairs
    bounds = _equidepth_bounds(mesh, r_sorted, s_keys, nv_r, nv_s)

    bflat, _, counts, ov_r = _cut_all(mesh, r_sorted, nv_r, bounds, cap_r)
    recv, rcounts = _receive(mesh, bflat, counts, cap_r, hier=hier)
    del bflat
    tr = _row_sums(mesh, rcounts)
    merged_r = [_merge_received(recv[me], rcounts[me], n, cap_r, fanin,
                                use_kernels) for me in range(n)]
    del recv

    bk, bp, counts, ov_s = _cut_all(mesh, s_keys, nv_s, bounds, cap_s,
                                    s_pays)
    recv_k, rcounts = _receive(mesh, bk, counts, cap_s, hier=hier)
    recv_p = _exchange(mesh, bp, cap_s, None, hier)
    del bk, bp
    ts = _row_sums(mesh, rcounts)
    merged_s = [_merge_received_pair(recv_k[me], recv_p[me], rcounts[me], n,
                                     cap_s, fanin, use_kernels)
                for me in range(n)]
    del recv_k, recv_p

    tr, ts = zip(*mesh.tolist(mesh.map(lambda a, b: torch.stack([a, b], -1),
                                       tr, ts)))
    rows = []
    for me in range(n):
        ok, op, om, nm = mat.materialize_matches(
            merged_r[me], tr[me], *merged_s[me], ts[me])
        if int(om.sum(dtype=torch.int64)) != nm:
            # some R key repeats: one output row per match pair; with none
            # the matched S rows are the output (models/mway.py does so)
            ok, op, _ = mat.expand_matches(ok, op, om, nm)
        rows.append((ok, op))
        merged_r[me] = merged_s[me] = None  # free each shard once done
    return rows, ov_r + ov_s


def dist_join_materialize(rkeys, rpayloads, skeys, spayloads, n_r: int,
                          n_s: int, mesh: Mesh, slack: float = 2.0,
                          block: int = BLOCKSIZE_DEFAULT,
                          fanin: int | None = FANIN_DEFAULT,
                          use_kernels: bool = True,
                          stream_to: Optional[str] = None):
    """Materialized distributed equi-join over ``mesh``.

    Returns ``(out_keys, out_payloads, count, overflow)``: int32 columns on
    the mesh's device (its first shard's) of every matched <S-key,
    S-payload> row (one row per match pair, duplicate R keys expanded),
    shard by shard; the match count;
    the bucket overflow, 0 unless the slack retries ran out (a bucket
    overflow doubles the slack and retries, up to 16, as the JAX package
    does; ``LAST_RETRIES`` holds how many this call took).  ``rpayloads``
    is accepted for the JAX signature and never read: R's payloads do not
    travel.

    ``stream_to``: the path of an ``Out.tbl`` to write instead, truncated,
    then one shard's rows appended at a time; the returned columns are
    then None.
    """
    global LAST_RETRIES
    _check_fanin(fanin)
    retries = 0
    while True:
        rows, ov = _join(rkeys, skeys, spayloads, n_r, n_s, mesh, slack,
                         block, fanin, use_kernels)
        if ov == 0 or slack >= 16.0:
            break
        del rows
        slack *= 2
        retries += 1
    LAST_RETRIES = retries
    count = sum(k.numel() for k, _ in rows)
    if stream_to is not None:
        from ..datagen import append_rows

        open(stream_to, "w").close()  # truncate
        for keys, pays in rows:
            if keys.numel():
                append_rows(stream_to, keys.cpu().numpy(),
                            pays.cpu().numpy())
        return None, None, count, ov
    # every shard's rows gathered onto the mesh's device
    return (torch.cat([k.to(mesh.device) for k, _ in rows]),
            torch.cat([p.to(mesh.device) for _, p in rows]), count, ov)
