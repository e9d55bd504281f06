"""Distributed m-way count join over a mesh of shards (counterpart of
``avx_sort_merge_joins_tpu/parallel/dist_mway.py:54-100,185-780``;
reference: src/joins/sortmergejoin_multiway.c, whose threads sort their
partitions, gather one partition's sorted runs from every thread, the
remote reads of :504-518, and multi-way merge them).

Per shard, written SPMD-style with an explicit ``me`` between the mesh's
collectives (``parallel/mesh.py``):

  sort       -- the shard's keys sorted by the multiway sort (K1 + K2);
  exchange   -- equi-depth splitters from 16 quantiles per relation per
                shard (an all-gather); each shard cuts its sorted run into
                one contiguous bucket per destination (slice copies into
                one preallocated row a shard) and the buckets move by
                all-to-all (one landing at a time: each is merged and cut
                to its live keys before the next), by NEXT/RING/RANDOM
                permute rounds, or in two stages on a 2-D mesh;
  merge      -- the received runs k-way merged: the varlen K2 with run
                lengths in a device vector, or the chunk-gated receiver
                merge K9 (``remote_pull="emulate"``), or, with
                ``overlap=True``, group merges in arrival order and a final
                two-way merge; with ``remote_pull="dma"`` the exchange and
                the merge are one K11 launch a relation and card, the
                pushes and the gated merges of its shards together;
  mergejoin  -- K3 per shard over its owned key range, in int64; the count
                is the host sum over shards (disjoint key ranges).

``use_kernels=False`` takes the ``torch.sort`` baseline route (the JAX
package's ``use_pallas=False``): the local sorts and the merge of the
received runs are ``torch.sort``.  On a mesh on the CPU every kernel takes
its plain version; on the card it launches or raises.

TPU workarounds dropped: the ``(rows, 128)`` layouts and spare window rows,
the base-2^30 count limbs and ``CountLimbOverflow`` (the count is int64, so
a hot key with cntR * cntS >= 2^29 on one shard counts exactly), and the
jit caches of the shard programs.  The bucket alignment stays the JAX
package's 16,384 keys (its ``tile_rows * 128``), so capacities, overflow
and the slack-doubling retry match its own.

The shards' values are the mesh's per-shard values (``parallel/mesh.py``:
stacks on a mesh of one device, one tensor a shard on a mesh of one
device a shard), and this module has one path for both.  Host scalars
(bucket starts, live totals, counts) are read from every shard's device
to the host; the splitters are made on every shard's device from its copy
of the gathered samples.

Footprint: on a mesh of one device every shard lives there, so the 1.6B ⋈
1.6B workload (``parallel/scale.py``) would not fit as a sum of
per-device buffers.  The buckets are cut straight into one preallocated
row a shard (no per-shard copies, gather index or ``torch.stack``), the
bulk exchange delivers and merges one landing at a time, and each merged
column keeps only its live keys.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..models.common import device_sync
from ..ops import mergejoin, multiwaymerge as mw, sort as sort_ops
from ..ops.bitonic import KEY_POS_INF
from ..params import BLOCKSIZE_DEFAULT
from ..types import NumaStrategy
from ..utils.log import warn
from ..utils.profiling import span
from . import exchange as ex
from . import remote_fifo as rf
from .mesh import (Mesh, chips_per_host_of, host_shape, is_2d,
                   shuffle_order)

# no fan-in named: the local sorts merge in their default plan
# (multiwaymerge.plan_fanins), the received runs greedily at
# multiwaymerge.greedy_fanin's (the JAX package's 16)
FANIN_DEFAULT = mw.FANIN_DEFAULT
# Bucket capacities align to the JAX package's merge tile (128 x 128 keys)
# so that they, and with them overflow and the retry, equal its own.
TILE_ELEMS = 128 * 128
NQ = 16  # splitter samples per relation per shard
# the slack the most recent dist_mway_join_count / _phased call ended at
# (its start, doubled once per bucket-overflow retry)
LAST_SLACK: Optional[float] = None
BOUND_MIN = -(2**31) + 1  # bounds[0]: below every live key


def _pow2_runs(n: int) -> int:
    return n if n & (n - 1) == 0 else 1 << (n - 1).bit_length()


def _local_sorted(keys: torch.Tensor, block: int, fanin: int | None,
                  use_kernels: bool) -> torch.Tensor:
    """One shard's keys ascending, pads (INT32_MAX) last: the multiway sort
    (K1 + K2), or ``torch.sort`` on the baseline route.  The live prefix is
    ``[:keys.numel()]``; the column has at least one slot, as the JAX
    package's padded rows do, so that an empty shard's splitter samples
    read its pad."""
    if use_kernels:
        return mw.multiway_sort(keys, keys.numel(), block, fanin)
    return torch.sort(_at_least_one_slot(keys)).values


def _at_least_one_slot(col: torch.Tensor) -> torch.Tensor:
    return col if col.numel() else torch.full(
        (1,), KEY_POS_INF, dtype=col.dtype, device=col.device)


def _local_sorted_pair(keys: torch.Tensor, payloads: torch.Tensor,
                       block: int, fanin: int | None, use_kernels: bool):
    """One shard's (key, payload) pairs in lexicographic order, pads
    (INT32_MAX, INT32_MAX) last: the multiway sort with payloads (K5 + K6),
    or one ``torch.sort`` of the packed pairs on the baseline route.
    Returns ``(keys, payloads)`` with at least one slot each."""
    if use_kernels:
        return mw.multiway_sort(keys, keys.numel(), block, fanin,
                                payloads=payloads)
    return sort_ops.unpack_pairs(torch.sort(sort_ops.pack_pairs(
        _at_least_one_slot(keys), _at_least_one_slot(payloads))).values)


def _bucket_starts(ks: torch.Tensor, n_valid: int, bounds: torch.Tensor,
                   n_chips: int) -> torch.Tensor:
    """Where the per-destination buckets of one shard's sorted column lie:
    bucket d holds the live keys in [bounds[d], bounds[d+1]), the slice
    ``[starts[d], starts[d+1])`` found by a rank search.  Returns the
    ``(n_chips + 1,)`` int64 starts on the column's device."""
    dev = ks.device
    inner = torch.searchsorted(ks[:n_valid], bounds[1:]) if n_chips > 1 \
        else torch.zeros(0, dtype=torch.int64, device=dev)
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), inner,
                      torch.full((1,), n_valid, dtype=torch.int64,
                                 device=dev)])


def _equidepth_bounds(mesh: Mesh, r_sorted, s_sorted, nvr, nvs):
    """Equi-depth splitters: each shard samples ``NQ`` quantiles of each
    sorted relation, at ``(nv // NQ) * j`` clamped to the live prefix (an
    empty shard reads its +inf pad at index 0, as the JAX package's clamped
    ``dynamic_slice`` does); the gathered samples, sorted, give bounds[d]
    = samples[(ns * d) // n].  Returns a replicated value (one tensor on a
    one-device mesh, a copy on each shard's device otherwise,
    :meth:`Mesh.replica`) of n int32 bounds, bounds[0] = -2^31 + 1.  The
    sample positions are made on the device: the host waits for nothing."""
    n = mesh.n

    def positions(col, nv):
        nv = int(nv)
        return (torch.arange(NQ, device=col.device) * (nv // NQ)).clamp_(
            max=max(nv - 1, 0))

    rows = []
    for me in range(n):
        rc, sc = r_sorted[me], s_sorted[me]
        rows.append(torch.stack([rc[positions(rc, nvr[me])],
                                 sc[positions(sc, nvs[me])]],
                                dim=1).reshape(-1))

    def bounds_of(gathered):
        samples = torch.sort(gathered).values
        ns = samples.numel()
        pick = torch.arange(1, n, device=samples.device) * ns // n
        return torch.cat([torch.full((1,), BOUND_MIN, dtype=torch.int32,
                                     device=samples.device), samples[pick]])

    return mesh.replicated(bounds_of, mesh.all_gather(mesh.stack(rows)))


def _exchange(mesh: Mesh, bflat, cap: int, schedule, hier=None):
    """Deliver bucket d of every shard to shard d.  ``schedule=None``: one
    all-to-all; otherwise a list of rotation offsets
    (:func:`mesh.shuffle_order`) run as collective-permute rounds.  On a 2-D
    mesh (``hier``) the two-stage exchange, the schedule applied to the
    host tier."""
    if hier is not None:
        return ex.exchange_hier(mesh, bflat, cap, host_schedule=schedule)
    if schedule is None:
        return mesh.all_to_all(bflat)
    n = mesh.n
    out = mesh.zeros_like(bflat)
    for off in schedule:
        off = int(off)
        # shard x sends its bucket for (x + off) mod n to that shard
        piece = mesh.rotated_blocks(bflat, cap, off)
        if off != 0:
            piece = mesh.ppermute(piece, [(x, (x + off) % n)
                                          for x in range(n)])
        mesh.put_rotated_blocks(out, piece, cap, -off)
    return out


def _merge_levels_varlen(keys: torch.Tensor, lens: torch.Tensor,
                         stride: int, nruns: int, fanin: int | None,
                         payloads: torch.Tensor | None = None):
    """k-way merge levels of the varlen K2 (K6 with ``payloads``) until one
    run is left, at ``mw.greedy_fanin(fanin)``.  Returns ``(merged,
    lens)``, ``merged`` a column or a ``(keys, payloads)`` tuple, as
    ``multiway_merge`` returns it."""
    fanin = mw.greedy_fanin(fanin)
    while nruns > 1:
        w = min(max(2, fanin), nruns)
        merged, lens = mw.multiway_merge(keys, w, payloads=payloads,
                                         lens=lens, stride=stride)
        keys, payloads = merged if payloads is not None else (merged, None)
        stride *= w
        nruns = -(-nruns // w)
    return (keys if payloads is None else (keys, payloads)), lens


def _pad_runs(recv: torch.Tensor, counts: torch.Tensor, n: int, cap: int,
              nruns: int, payloads: torch.Tensor | None = None):
    """One shard's received runs padded to ``nruns`` with empty ones.
    Returns ``(keys, counts, payloads or None)``."""
    extra = nruns - n
    if extra == 0:
        return recv, counts, payloads
    dev = recv.device

    def pad(col, fill):
        return torch.cat([col, torch.full((extra * cap,), fill,
                                          dtype=torch.int32, device=dev)])

    return (pad(recv, KEY_POS_INF),
            torch.cat([counts, torch.zeros(extra, dtype=torch.int32,
                                           device=dev)]),
            None if payloads is None else pad(payloads, 0))


def _merge_received(recv: torch.Tensor, counts: torch.Tensor, n: int,
                    cap: int, fanin: int | None,
                    use_kernels: bool) -> torch.Tensor:
    """One shard's received runs (run s at ``[s*cap, s*cap + counts[s])``)
    k-way merged into one ascending column: the varlen K2 with fan-in
    ``min(fanin, nruns)`` per level, a shard count that is not a power of
    two padded with empty runs; ``torch.sort`` on the baseline route.  The
    span ``smj.dist.merge``."""
    with span("smj.dist.merge"):
        if not use_kernels:
            return torch.sort(recv).values
        nruns = _pow2_runs(n)
        keys, lens, _ = _pad_runs(recv, counts, n, cap, nruns)
        return _merge_levels_varlen(keys, lens, cap, nruns, fanin)[0]


def _landing_merged(mesh: Mesh, bflat, rcounts, me: int, n: int, cap: int,
                    fanin: int | None, use_kernels: bool) -> torch.Tensor:
    """Shard ``me``'s landing of the bulk all-to-all (span
    ``smj.dist.exchange``), merged."""
    with span("smj.dist.exchange"):
        landing = mesh.all_to_all_row(bflat, me)
    return _merge_received(landing, rcounts[me], n, cap, fanin, use_kernels)


def _merge_received_pair(recv_k: torch.Tensor, recv_p: torch.Tensor,
                         counts: torch.Tensor, n: int, cap: int,
                         fanin: int | None, use_kernels: bool):
    """:func:`_merge_received` of (key, payload) runs in lexicographic
    order: the varlen K6, or one ``torch.sort`` of the packed pairs on the
    baseline route.  Returns ``(keys, payloads)``; the live prefix is the
    sum of ``counts``."""
    if not use_kernels:
        return sort_ops.unpack_pairs(torch.sort(sort_ops.pack_pairs(
            recv_k, recv_p)).values)
    nruns = _pow2_runs(n)
    keys, lens, pays = _pad_runs(recv_k, counts, n, cap, nruns, recv_p)
    return _merge_levels_varlen(keys, lens, cap, nruns, fanin, pays)[0]


def _merge_received_gated(recv: torch.Tensor, counts: torch.Tensor, n: int,
                          cap: int, pull_rate: int):
    """One shard's received runs merged by the chunk-gated receiver K9,
    under an arrival schedule shaped like the push schedule's chunk-major
    walk (``pull_rate`` merge rounds per push round).  At least two strips
    (a one-shard mesh gets an empty second one).  Returns (merged,
    violation)."""
    nruns = max(2, _pow2_runs(n))
    landing, lens, _ = _pad_runs(recv, counts, n, cap, nruns)
    chunk = rf.pick_chunk_elems(cap, TILE_ELEMS, nruns)
    arrive = rf.arrival_schedule(nruns, cap // chunk, rate=pull_rate)
    merged, _waited, viol = rf.chunk_gated_merge(landing, lens, cap, chunk,
                                                 arrive)
    return merged, viol


def _arrivals(mesh: Mesh, bflat, counts, cap: int):
    """Permute-round delivery: round t brings each shard the bucket of
    shard (me - t), one ``mesh.ppermute`` a round.  Yields each round's
    per-shard ``(cap,)`` piece and 0-d count as it arrives."""
    n = mesh.n
    for t in range(n):
        piece = mesh.rotated_blocks(bflat, cap, t)
        cnt = mesh.map(lambda c: c.squeeze(-1),
                       mesh.rotated_blocks(counts, 1, t))
        if t:
            perm = [(x, (x + t) % n) for x in range(n)]
            piece, cnt = mesh.ppermute(piece, perm), mesh.ppermute(cnt, perm)
        yield piece, cnt


def _overlap_receive(mesh: Mesh, bflat, counts, cap: int, fanin: int | None,
                     ngroups: int = 2):
    """Permute-round delivery (:func:`_arrivals`) with group merges as the
    groups fill: the runs of each ``n / ngroups`` consecutive rounds k-way
    merge as one group (the reference's merge-while-reading,
    sortmergejoin_multiway.c:494-518), and one two-way merge of the groups
    finishes.  Returns the merged column of each shard."""
    n = mesh.n
    pieces, cnts = zip(*_arrivals(mesh, bflat, counts, cap))
    per_group = n // ngroups
    merged = []
    for m in range(n):
        groups, glens = [], []
        for g in range(ngroups):
            rounds = range(g * per_group, (g + 1) * per_group)
            keys, lens = _merge_levels_varlen(
                torch.cat([pieces[t][m] for t in rounds]),
                torch.stack([cnts[t][m] for t in rounds]), cap, per_group,
                fanin)
            groups.append(keys)
            glens.append(lens)
        out, _ = mw.multiway_merge(torch.cat(groups), ngroups,
                                   lens=torch.cat(glens),
                                   stride=per_group * cap)
        merged.append(out)
    return merged


def _stage(keys, n_keys: int, shard: int, mesh: Mesh, pre_sharded: bool):
    """One relation as a per-shard value of ``(shard,)`` rows:
    ``keys[:n_keys]`` padded with +inf, or an already sharded array (an
    ``(n, shard)`` tensor, or a list of one ``(shard,)`` tensor a shard)."""
    if not pre_sharded:
        return mesh.shard(ex.pad_column(keys[:n_keys], shard * mesh.n,
                                        KEY_POS_INF, device=mesh.device)
                          .reshape(mesh.n, shard))
    if isinstance(keys, (list, tuple)):
        rows = [torch.as_tensor(k, dtype=torch.int32) for k in keys]
        shapes = {tuple(r.shape) for r in rows}
        shape = (len(rows), *(shapes.pop() if len(shapes) == 1 else
                              [sorted(shapes)]))
    else:
        rows = torch.as_tensor(keys, dtype=torch.int32)
        shape = tuple(rows.shape)
    if shape != (mesh.n, shard):
        raise ValueError(f"pre_sharded: shape {shape}, want "
                         f"{(mesh.n, shard)}")
    if isinstance(rows, list):
        return mesh.stack(r.contiguous() for r in rows)
    return mesh.shard(rows.contiguous())


def _schedule(mesh: Mesh, numa_strategy, next_as_rounds: bool):
    """The exchange's rotation offsets, or None for one all-to-all: on a
    2-D mesh the strategy schedules the host tier; RING strides by the
    mesh's host granularity (numa_shuffle.c:80)."""
    if is_2d(mesh):
        if numa_strategy is None:
            return None
        return shuffle_order(numa_strategy, mesh.hosts[0], 1).tolist()
    if numa_strategy is not None and numa_strategy != NumaStrategy.NEXT:
        return shuffle_order(numa_strategy, mesh.n,
                             chips_per_host_of(mesh)).tolist()
    if numa_strategy == NumaStrategy.NEXT and next_as_rounds:
        return list(range(mesh.n))
    return None


def _shape(n_keys: int, n: int, slack: float):
    """One relation's layout over ``n`` shards at one slack: ``(shard,
    cap, nv)``, the shard size, the bucket capacity and each shard's live
    count."""
    shard = -(-n_keys // n)
    return (shard, ex.bucket_cap(shard, n, slack, TILE_ELEMS),
            ex.valid_counts(n_keys, shard, n))


def _cut_all(mesh: Mesh, ks: list, nv, bounds, cap: int, ps=None):
    """Every shard's buckets (:func:`_bucket_starts`), cut straight into
    one preallocated ``(n*cap,)`` row a shard and column (+inf key pads, 0
    payload pads): one slice copy a bucket of at most ``cap`` keys, no
    gather index, per-shard copy or ``torch.stack``.  The bucket starts of
    every shard come to the host in one read a device.  Frees each sorted
    column of ``ks`` (and ``ps``) once it is cut.  Returns ``(keys,
    payloads or None, int32 counts (n,) a shard, overflow)``, the first
    three per-shard values of the mesh: the keys each bucket kept; the
    overflow, those that did not fit, a host int."""
    n = len(ks)
    starts = mesh.tolist(mesh.stack(
        _bucket_starts(ks[me], int(nv[me]), mesh.replica(bounds, me), n)
        for me in range(n)))
    bk = mesh.full((n * cap,), KEY_POS_INF)
    bp = None if ps is None else mesh.zeros_like(bk)
    counts, overflow = [], 0
    for me in range(n):
        cols = [(bk[me], ks[me])] + ([] if ps is None else [(bp[me], ps[me])])
        row_counts = []
        for d in range(n):
            a, ln = starts[me][d], starts[me][d + 1] - starts[me][d]
            keep = min(ln, cap)
            overflow += ln - keep
            row_counts.append(keep)
            for row, col in cols:
                row[d * cap:d * cap + keep] = col[a:a + keep]
        counts.append(row_counts)
        ks[me] = None
        if ps is not None:
            ps[me] = None
    del ks[:]
    if ps is not None:
        del ps[:]
    return bk, bp, mesh.from_host(counts), overflow


def _receive(mesh: Mesh, bflat, counts, cap: int, schedule=None, hier=None):
    """:func:`_exchange` of the buckets and of their counts: ``(recv,
    rcounts)``, shard d's run from shard s at ``recv[d][s*cap:]`` with
    ``rcounts[d][s]`` keys."""
    recv = _exchange(mesh, bflat, cap, schedule, hier)
    rcounts = ex.exchange_hier(mesh, counts, 1) if hier else \
        mesh.all_to_all(counts)
    return recv, rcounts


def _row_sums(mesh: Mesh, counts):
    """Each shard's sum of its ``(n,)`` counts row: its live total."""
    return mesh.map(lambda c: c.sum(-1), counts)


def _live_prefixes(mesh: Mesh, cols, totals) -> list:
    """Each shard's merged column cut to its live keys (at least one slot):
    a copy of ``col[:total]``, taken as ``cols`` yields each column, so
    that a full merged landing is freed before the next is made.  K3 reads
    no slot past its length."""
    live = mesh.tolist(totals)
    return [col[:max(t, 1)].clone() for col, t in zip(cols, live)]


def _count_owned(mesh: Mesh, merged_r: list, merged_s: list, totals_r,
                 totals_s) -> int:
    """K3 per shard over the merged columns of its owned key range, the
    live lengths read once for every shard; the host sum over shards
    (disjoint key ranges) is the count, in int64."""
    tr, ts = zip(*mesh.tolist(mesh.map(lambda a, b: torch.stack([a, b], -1),
                                       totals_r, totals_s)))
    return mesh.host_sum(mergejoin.merge_join_count_fused(
        merged_r[me], merged_s[me], tr[me], ts[me])
        for me in range(len(tr)))


def _join(rkeys, skeys, n_r: int, n_s: int, mesh: Mesh, slack: float,
          block: int, fanin: int | None, use_kernels: bool, schedule,
          pre_sharded: bool, overlap_ok: bool, remote_pull, pull_rate: int,
          timed: bool = False):
    """One run of the pipeline at one slack: (count, overflow, phases).
    With ``timed`` each phase is timed on the host clock after a device
    sync; without it ``phases`` is empty and the host waits for the device
    only where it reads a value.  Each step is a span ``smj.dist.<step>``."""
    n = mesh.n
    hier = host_shape(mesh) if is_2d(mesh) else None
    shard_r, cap_r, nv_r = _shape(n_r, n, slack)
    shard_s, cap_s, nv_s = _shape(n_s, n, slack)
    rk = _stage(rkeys, n_r, shard_r, mesh, pre_sharded)
    sk = _stage(skeys, n_s, shard_s, mesh, pre_sharded)
    phases, t0 = {}, 0.0

    def lap(name, ready):
        nonlocal t0
        if timed:
            if ready is not None:
                device_sync(ready)
            now = time.perf_counter()
            if name:
                phases[name] = now - t0
            t0 = now

    lap(None, sk)
    with span("smj.dist.sort"):
        r_sorted = [_local_sorted(rk[me], block, fanin, use_kernels)
                    for me in range(n)]
        s_sorted = [_local_sorted(sk[me], block, fanin, use_kernels)
                    for me in range(n)]
    lap("sort", s_sorted)

    with span("smj.dist.splitters"):
        bounds = _equidepth_bounds(mesh, r_sorted, s_sorted, nv_r, nv_s)
    merged, totals, overflow, viols = {}, {}, 0, []
    for side, ks, nv, cap in (("r", r_sorted, nv_r, cap_r),
                              ("s", s_sorted, nv_s, cap_s)):
        with span("smj.dist.cut"):
            bflat, _, counts, ov = _cut_all(mesh, ks, nv, bounds, cap)
        overflow += ov
        if overlap_ok:
            with span("smj.dist.exchange"):
                totals[side] = _row_sums(mesh, mesh.all_to_all(counts))
                out = _overlap_receive(mesh, bflat, counts, cap, fanin)
            merged[side] = _live_prefixes(mesh, out, totals[side])
            continue
        if remote_pull == "dma":
            with span("smj.dist.exchange"):
                rcounts = mesh.all_to_all(counts)
                totals[side] = _row_sums(mesh, rcounts)
                chunk = rf.pick_chunk_elems(cap, TILE_ELEMS, n)
                out, _waited, viol, _landing = rf.remote_pull_exchange_merge(
                    mesh, bflat, rcounts, cap, chunk)
            del bflat, _landing
            merged[side] = _live_prefixes(mesh, out, totals[side])
            viols += [viol[me] for me in range(n)]
            continue
        if schedule is None and hier is None and remote_pull is None:
            # the bulk all-to-all a landing at a time, each merged and cut
            # to its live keys before the next: one landing a device, not
            # the whole receive stack beside the bucket stack
            with span("smj.dist.exchange"):
                rcounts = mesh.all_to_all(counts)
            totals[side] = _row_sums(mesh, rcounts)
            merged[side] = _live_prefixes(mesh, (
                _landing_merged(mesh, bflat, rcounts, me, n, cap, fanin,
                                use_kernels) for me in range(n)),
                totals[side])
            del bflat
            continue
        with span("smj.dist.exchange"):
            recv, rcounts = _receive(mesh, bflat, counts, cap, schedule,
                                     hier)
        del bflat
        totals[side] = _row_sums(mesh, rcounts)
        if remote_pull == "emulate":
            with span("smj.dist.merge"):
                out = [_merge_received_gated(recv[me], rcounts[me], n, cap,
                                             pull_rate) for me in range(n)]
            viols += [o[1] for o in out]
            merged[side] = _live_prefixes(mesh, (o[0] for o in out),
                                          totals[side])
        else:
            merged[side] = _live_prefixes(mesh, (
                _merge_received(recv[me], rcounts[me], n, cap, fanin,
                                use_kernels) for me in range(n)),
                totals[side])
        del recv
    lap("merge1", merged["s"])

    with span("smj.dist.count"):
        count = _count_owned(mesh, merged["r"], merged["s"], totals["r"],
                             totals["s"])
    lap("mergejoin", None)  # the count is on the host
    if timed:
        phases["total"] = (phases["sort"] + phases["merge1"]
                           + phases["mergejoin"])
    if viols and mesh.host_sum(viols):
        raise RuntimeError("chunk-gated merge read past a delivered prefix: "
                           "the remote-pull gating arithmetic regressed")
    return count, overflow, phases


def _check_fanin(fanin: int | None) -> None:
    if fanin is not None and (fanin < 2 or fanin & (fanin - 1)):
        raise ValueError(
            f"fanin must be a power of two >= 2, got {fanin} (the k-way "
            "merge's group math requires it)")


def _check_remote_pull(remote_pull, mesh: Mesh, use_kernels: bool,
                       overlap: bool) -> None:
    """Raise unless ``remote_pull`` is None, ``"emulate"`` or ``"dma"``,
    and on ``"dma"`` unless K11 takes the run: the kernel pipeline on a
    flat mesh of a power of two >= 2 shards, without overlap, every pair of
    its cards with peer access."""
    if remote_pull not in (None, "emulate", "dma"):
        raise ValueError(f"remote_pull={remote_pull!r}: not None, 'emulate' "
                         "or 'dma'")
    n = mesh.n
    if remote_pull == "dma" and (overlap or is_2d(mesh) or not use_kernels
                                 or n < 2 or n & (n - 1)):
        raise ValueError(
            "remote_pull='dma' needs the kernel pipeline on a flat mesh of a "
            "power of two >= 2 shards, without overlap "
            f"(use_kernels={use_kernels}, n_chips={n}, "
            f"mesh_axes={mesh.axis_names}, overlap={overlap})")
    if remote_pull == "dma":
        rf._check_peers(mesh)


def dist_mway_join_count(rkeys, skeys, n_r: int, n_s: int, mesh: Mesh,
                         slack: float = 2.0, block: int = BLOCKSIZE_DEFAULT,
                         fanin: int | None = FANIN_DEFAULT,
                         use_kernels: bool = True,
                         numa_strategy: Optional[str] = None,
                         pre_sharded: bool = False,
                         overlap: bool = False,
                         remote_pull: Optional[str] = None,
                         pull_rate: int = 1):
    """Distributed m-way equi-join match count over ``mesh``.

    Returns (count, overflow) as host ints; overflow must be 0.  A bucket
    overflow doubles the slack and retries, up to 16, as the JAX package
    does; past that it is returned.  The call is the span ``smj.join``; it
    times nothing, so the host waits for the device only to read the bucket
    starts, the live totals and the count.

    ``rkeys``/``skeys`` are 1-D key columns (numpy or torch, anywhere) of
    logical sizes ``n_r``/``n_s``, or with ``pre_sharded`` the ``(n,
    shard)`` arrays of JAX's pre-sharded input, sizes dividing evenly.
    A 2-D mesh (``make_mesh2d``) exchanges in two stages, the NEXT/RING/
    RANDOM schedule applied to the host tier.

    ``overlap=True`` delivers the buckets in permute rounds and merges the
    runs in two groups as they arrive, then the groups: one more k-way
    pass.  It needs the kernel pipeline, a flat mesh and a power-of-two
    shard count >= 4, and falls back loudly otherwise.

    ``remote_pull="emulate"`` merges the received runs through the
    chunk-gated receiver K9, as if they arrived chunk by chunk
    (``pull_rate`` merge rounds per push round), and raises on a gating
    violation.  It needs the kernel pipeline on a flat mesh without
    overlap and falls back loudly otherwise.

    ``remote_pull="dma"`` is the real push: per relation, one K11 launch
    a card (``remote_fifo.remote_pull_exchange_merge``) pushes its shards'
    buckets chunk by chunk into their peers' landing strips, by NVLink
    peer writes to other cards, and merges its shards' strips as they
    arrive; only the bucket counts go by all-to-all first.  The chunk is
    the emulate route's.  It raises on a gating violation, and it raises,
    never falls back, on what K11 does not take: a 2-D mesh, ``overlap``,
    ``use_kernels=False``, a shard count that is not a power of two >= 2
    (the JAX kernel asserts the same, remote_fifo.py:374), a pair of the
    mesh's cards without peer access.  It takes any ``numa_strategy``: a
    schedule orders only the bulk exchange's rounds, which the pushes
    replace, and K11 pushes in NEXT order.  This is the JAX package's own
    value of the argument, defined by its module's test plan (step 3),
    made runnable: the JAX ``dist_mway`` raises on it only for want of
    several chips.
    """
    _check_fanin(fanin)
    n = mesh.n
    hier = host_shape(mesh) if is_2d(mesh) else None
    _check_remote_pull(remote_pull, mesh, use_kernels, overlap)
    overlap_ok = (overlap and use_kernels and hier is None and n >= 4
                  and n & (n - 1) == 0)
    if overlap and not overlap_ok:
        warn("dist m-way overlap=True requires the kernel pipeline, a flat "
             "mesh, and a power-of-two shard count >= 4 "
             f"(use_kernels={use_kernels}, n_chips={n}, "
             f"mesh_axes={mesh.axis_names}); running the bulk all_to_all "
             "path")
    if remote_pull == "emulate":
        if overlap_ok or hier is not None or not use_kernels:
            warn("remote_pull='emulate' requires the kernel pipeline on a "
                 "flat mesh without overlap; running the bulk path")
            remote_pull = None
    if (overlap_ok and numa_strategy is not None
            and numa_strategy != NumaStrategy.NEXT):
        warn(f"overlap=True ignores numa_strategy={numa_strategy} "
             "(the permute rounds are sequential by construction)")
    global LAST_SLACK
    schedule = _schedule(mesh, numa_strategy, next_as_rounds=True)
    with span("smj.join"):
        while True:
            LAST_SLACK = slack
            count, ov, _ = _join(rkeys, skeys, n_r, n_s, mesh, slack, block,
                                 fanin, use_kernels, schedule, pre_sharded,
                                 overlap_ok, remote_pull, pull_rate)
            if ov == 0 or slack >= 16.0:
                return count, ov
            # extreme skew overflowed a bucket: retry with doubled capacity
            slack *= 2


def dist_mway_join_phased(rkeys, skeys, n_r: int, n_s: int, mesh: Mesh,
                          slack: float = 2.0,
                          block: int = BLOCKSIZE_DEFAULT,
                          fanin: int | None = FANIN_DEFAULT,
                          use_kernels: bool = True,
                          numa_strategy: Optional[str] = None,
                          pre_sharded: bool = False):
    """The distributed m-way count with per-phase times: (count, overflow,
    phases), phases sort / merge1 (splitters, exchange and merge of the
    received runs) / mergejoin / total in seconds, each on the host clock
    after ``torch.cuda.synchronize`` (the reference's SORT / MERGE1 / MJOIN
    record columns, joincommon.c:175-196).  NEXT exchanges by one
    all-to-all here, as in the JAX package.  The times of the run that
    returns, after any slack retry."""
    global LAST_SLACK
    _check_fanin(fanin)
    schedule = _schedule(mesh, numa_strategy, next_as_rounds=False)
    with span("smj.join"):
        while True:
            LAST_SLACK = slack
            count, ov, phases = _join(rkeys, skeys, n_r, n_s, mesh, slack,
                                      block, fanin, use_kernels, schedule,
                                      pre_sharded, False, None, 1, timed=True)
            if ov == 0 or slack >= 16.0:
                return count, ov, phases
            slack *= 2
