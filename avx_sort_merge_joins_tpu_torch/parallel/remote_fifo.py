"""The remote pull: host helpers of the chunked push schedule, the
chunk-gated merge K9, and the push and gated merge K11 (counterpart of
``avx_sort_merge_joins_tpu/parallel/remote_fifo.py:74-413``; reference:
src/merge/avx_multiwaymerge.c:605-728 readmerge, which reads remote NUMA
runs through the merge, and sortmergejoin_multiway.c:494-518).

In the remote pull, every shard pushes its bucket for shard d to d in
fixed-size chunks, and d's k-way merge reads each source's landing strip
as a leaf that becomes readable chunk by chunk.

* :func:`chunk_gated_merge` (K9) runs the receiver's side with the
  arrivals emulated: an arrival-round table says when chunk j of strip r
  lands, the merge consumes only delivered prefixes, and it reports the
  chunk waits per strip and a flag that is set if it would ever read past
  a delivered prefix.  On a CUDA tensor it launches
  ``csrc/chunk_gated_merge.cu``; on a CPU tensor it takes the plain
  version :func:`chunk_gated_merge_plain`.
* :func:`remote_pull_exchange_merge` (K11) runs both sides for real on a
  mesh of N shards (``parallel/mesh.py``): each shard's pushes are copies
  into its peers' landing strips, peer writes over NVLink where a peer
  lies on another card, each arrival a flag in the receiver's memory, and
  each shard's merge waits for the arrivals it reads.  On a CUDA mesh it
  launches ``csrc/remote_pull.cu`` once a card, for the shards that card
  holds (once in all on a mesh of one card); on a CPU mesh it takes the
  plain version :func:`remote_pull_exchange_merge_plain`.

The host helpers are the JAX package's, line for line, with its
``max_entries=512`` in :func:`pick_chunk_elems`: it fixes the chunk size,
and with it the wait counters.  ``SMJ_REMOTE_DMA`` stays the JAX
package's switch (:func:`remote_dma_enabled`); the port reaches K11 by
``dist_mway_join_count(..., remote_pull="dma")`` without it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..kernels import _build
from ..ops.bitonic import KEY_POS_INF

# Output keys per merge tile: the kernel's (K2's merge-path tile;
# smj_chunk_gated_merge_tile reports it on the card), and the tiles the
# plain version gates with.
GATE_TILE = 4096
# The most shards K11 takes (its kMaxShards).
PULL_MAX_SHARDS = 256
# K11's status words ahead of its flags (its kScratchHead): the ticket
# counter (two words), the error and oversize words, the pushes done.
_PULL_SCRATCH_HEAD = 5
# K11's pointers a shard (its kTableWords, in its Slot order): buckets,
# received counts, landing, merged column, waits, violation flag, arrival
# flags, the card's control words.
_PULL_TABLE_WORDS = 8
# ordered pairs of cards (by index) with peer access enabled for K11
_PEERS: set = set()


def remote_dma_enabled() -> bool:
    """The dark-launch flag of the real push pipeline (``SMJ_REMOTE_DMA``,
    the JAX package's switch): set only when explicitly requested."""
    return os.environ.get("SMJ_REMOTE_DMA", "0") == "1"


@dataclass(frozen=True)
class ChunkPush:
    """One scheduled push: chunk ``chunk`` of my bucket for ``dst``."""
    round: int
    dst: int
    chunk: int
    start: int    # element offset within my bucket for dst
    size: int     # elements in this chunk (last chunk may be short)


def push_schedule(n_chips: int, me: int, bucket_lens, chunk_elems: int,
                  order=None) -> List[ChunkPush]:
    """The source side's push order: destinations in ``order`` (shuffle
    offsets; default NEXT), chunk-major, so round r pushes chunk r of every
    bucket that still has data and every destination's earliest chunks
    arrive first."""
    if order is None:
        order = list(range(n_chips))
    plan: List[ChunkPush] = []
    nchunks = [max(0, -(-int(bucket_lens[d]) // chunk_elems))
               for d in range(n_chips)]
    max_chunks = max(nchunks) if nchunks else 0
    for r in range(max_chunks):
        for off in order:
            d = (me + off) % n_chips
            if r < nchunks[d]:
                start = r * chunk_elems
                size = min(chunk_elems, int(bucket_lens[d]) - start)
                plan.append(ChunkPush(r, d, r, start, size))
    return plan


def landing_layout(n_chips: int, cap: int, chunk_elems: int
                   ) -> Tuple[int, int]:
    """(strip_elems, chunks_per_strip) of the receiver's landing buffer:
    source s's strip at [s*strip_elems, (s+1)*strip_elems), chunk j at
    strip offset j*chunk_elems -- the bulk exchange's received layout."""
    assert cap % chunk_elems == 0, "cap must be whole chunks"
    return cap, cap // chunk_elems


def leaf_wait_chunk(consumed_elem: int, window_elems: int,
                    chunk_elems: int) -> int:
    """Index of the last chunk a leaf window read touches: the reader must
    have waited for chunks [0 .. this] of that source before loading."""
    return (consumed_elem + window_elems - 1) // chunk_elems


def expected_sem_waits(total_windows: int, window_elems: int,
                       chunk_elems: int) -> List[int]:
    """For a leaf consuming ``total_windows`` windows in sequence, the chunk
    index each window load must wait for."""
    return [leaf_wait_chunk(w * window_elems, window_elems, chunk_elems)
            for w in range(total_windows)]


def arrival_schedule(n_src: int, chunks_per_strip: int, rate: int = 1,
                     order=None) -> np.ndarray:
    """(n_src, chunks_per_strip) arrival-round table: chunk j of source s
    arrives at round ``(j * n_src + pos(s)) * rate``, the receiver's view of
    :func:`push_schedule`'s chunk-major walk (rate 0: everything delivered
    at once, the bulk exchange).  Rows are non-decreasing, as
    :func:`chunk_gated_merge` requires."""
    if order is None:
        order = list(range(n_src))
    assert sorted(order) == list(range(n_src)), \
        "order must be a permutation of range(n_src)"
    pos = {s: i for i, s in enumerate(order)}
    out = np.zeros((n_src, chunks_per_strip), dtype=np.int32)
    for s in range(n_src):
        for j in range(chunks_per_strip):
            out[s, j] = (j * n_src + pos[s]) * rate
    return out


def pick_chunk_elems(cap: int, tile_elems: int, n_src: int,
                     max_entries: int = 512) -> int:
    """Largest-granularity chunk size (whole tiles, dividing ``cap``) that
    keeps the (n_src, chunks_per_strip) table within ``max_entries``."""
    assert cap % tile_elems == 0
    tiles = cap // tile_elems
    max_chunks = max(1, min(tiles, max_entries // n_src))
    per = -(-tiles // max_chunks)
    while tiles % per:
        per += 1
    return per * tile_elems


def push_window() -> int:
    """In-flight bound on outstanding pushes per shard
    (``SMJ_REMOTE_WINDOW``, default 32)."""
    return max(1, int(os.environ.get("SMJ_REMOTE_WINDOW", "32")))


def chunks_needed(consumed: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Chunks a reader must have received to have read a strip's prefix of
    ``consumed`` keys: ``leaf_wait_chunk(0, consumed, chunk) + 1``, and 0
    for an empty prefix."""
    return (consumed + chunk_elems - 1) // chunk_elems


def _checked(landing: torch.Tensor, lens: torch.Tensor, stride: int,
             chunk_elems: int, arrive_rounds) -> torch.Tensor:
    """Raise on what the merge does not take (the JAX wrapper's asserts,
    remote_fifo.py:219-228, less its TPU tiling and SMEM budget); return
    the arrival table as int32 on the landing's device."""
    arrive = np.asarray(arrive_rounds.cpu() if isinstance(
        arrive_rounds, torch.Tensor) else arrive_rounds)
    if arrive.ndim != 2:
        raise ValueError(f"chunk_gated_merge: arrival table of shape "
                         f"{arrive.shape}, not (W, max_chunks)")
    W, max_chunks = arrive.shape
    if W < 2 or W & (W - 1) or W > 1024:
        raise ValueError(f"chunk_gated_merge: {W} strips; pad the sources "
                         "to a power of two in [2, 1024]")
    if np.any(np.diff(arrive.astype(np.int64), axis=1) < 0):
        raise ValueError("chunk_gated_merge: arrival rounds must be "
                         "non-decreasing per source")
    if arrive.size and (arrive.min() < np.iinfo(np.int32).min
                        or arrive.max() > np.iinfo(np.int32).max):
        raise ValueError("chunk_gated_merge: arrival rounds outside int32")
    if chunk_elems < 1 or stride < 1 or stride % chunk_elems:
        raise ValueError(f"chunk_gated_merge: strips of {stride} keys do "
                         f"not hold whole chunks of {chunk_elems}")
    if stride // chunk_elems > max_chunks:
        raise ValueError(f"chunk_gated_merge: {stride // chunk_elems} chunks "
                         f"a strip, the table has {max_chunks}")
    if landing.dtype != torch.int32 or landing.dim() != 1 \
            or not landing.is_contiguous():
        raise ValueError("chunk_gated_merge: landing must be a contiguous "
                         "1-D int32 tensor")
    if landing.numel() < W * stride:
        raise ValueError(f"chunk_gated_merge: {landing.numel()} slots hold "
                         f"fewer than {W} strips of {stride}")
    if lens.dtype != torch.int32 or lens.shape != (W,) \
            or lens.device != landing.device or not lens.is_contiguous():
        raise ValueError(f"chunk_gated_merge: lens must be a contiguous "
                         f"int32[{W}] on {landing.device}")
    return torch.as_tensor(arrive.astype(np.int32), device=landing.device)


def chunk_gated_merge_plain(landing: torch.Tensor, lens: torch.Tensor,
                            stride: int, chunk_elems: int, arrive_rounds,
                            tile: int = GATE_TILE):
    """Plain version of K9: the kernel's tile, need, ready, round and
    violation arithmetic in torch, and the merge as a stable sort of the
    live keys (ties in strip order, as the kernel's co-ranks take them)."""
    arrive = _checked(landing, lens, stride, chunk_elems,
                      arrive_rounds).to(torch.int64)
    W = arrive.shape[0]
    dev = landing.device
    ln = lens.to(torch.int64).clamp(0, stride)
    host_ln = ln.tolist()
    vals = torch.cat([landing[r * stride:r * stride + host_ln[r]]
                      for r in range(W)])
    src = torch.repeat_interleave(torch.arange(W, device=dev), ln)
    merged, perm = torch.sort(vals, stable=True)
    total = vals.numel()
    out = torch.full_like(landing, KEY_POS_INF)
    out[:total] = merged
    violation = torch.zeros((), dtype=torch.int32, device=dev)
    waited = torch.zeros(W, dtype=torch.int32, device=dev)
    ntiles = -(-total // tile)
    if ntiles == 0:
        return out, waited, violation
    t = torch.arange(ntiles, dtype=torch.int64, device=dev)
    ends = torch.clamp((t + 1) * tile, max=total)
    src = src[perm]
    # consumed[r][t]: strip r's keys among the first ends[t] merged keys
    consumed = torch.stack([
        torch.searchsorted(torch.nonzero(src == r).flatten(), ends)
        for r in range(W)])
    need = chunks_needed(consumed, chunk_elems)
    at = torch.gather(arrive, 1, (need - 1).clamp(min=0))
    ready = torch.where(need > 0, at, 0).amax(0)
    # rho(t) = max(rho(t-1) + 1, ready(t)), rho(-1) = -1, as a prefix max
    rho = t + torch.cummax(ready - t, 0).values.clamp(min=0)
    delivered = torch.searchsorted(
        arrive, rho.expand(W, ntiles).contiguous(), right=True)
    violation |= (need > delivered).any().to(torch.int32)
    waited = need.amax(1).to(torch.int32)
    return out, waited, violation


def chunk_gated_merge(landing: torch.Tensor, lens: torch.Tensor,
                      stride: int, chunk_elems: int, arrive_rounds):
    """Receiver-side merge of W landing strips whose data arrives chunk by
    chunk (the emulated remote-pull merge).

    ``landing``       -- flat int32 buffer, strip r at ``[r*stride, ...)``,
                         ascending, ``lens[r]`` live keys (the bulk
                         exchange's received layout); W a power of two.
    ``lens``          -- int32[W] on the landing's device.
    ``arrive_rounds`` -- (W, max_chunks) int32 table: the merge round at
                         which chunk j of strip r becomes readable, rows
                         non-decreasing (:func:`arrival_schedule`); all
                         zeros is the bulk delivery.
    Returns ``(merged, waited, violation)``: the merged column (as many
    slots as ``landing``, INT32_MAX past the live total), the chunks each
    strip's reader waited for (ceil(lens[r] / chunk_elems)), and an int32
    0-d flag that is non-zero if the merge would have read past a
    delivered prefix.  Outputs stay on the device: no host sync."""
    if landing.device.type == "cpu":
        return chunk_gated_merge_plain(landing, lens, stride, chunk_elems,
                                       arrive_rounds)
    arrive = _checked(landing, lens, stride, chunk_elems, arrive_rounds)
    return _gated_launch(landing, lens, stride, chunk_elems, arrive)


def _gated_launch(landing: torch.Tensor, lens: torch.Tensor, stride: int,
                  chunk_elems: int, arrive: torch.Tensor, parts: int = 15,
                  scratch: torch.Tensor | None = None):
    """K9 on checked inputs (``arrive`` as :func:`_checked` returns it).
    ``parts``, a mask of 1 (coarse co-ranks), 2 (fine co-ranks), 8 (the
    gate) and 4 (the tile merge), picks the launches, the gate and the
    merge on the co-ranks ``scratch`` holds, for timing each."""
    from ..ops import multiwaymerge as mw

    W, max_chunks = arrive.shape
    if scratch is None:
        scratch = mw.corank_scratch(landing, 1, stride, W)
    out = torch.empty_like(landing)
    stats = torch.empty(W + 1, dtype=torch.int32, device=landing.device)
    if _build.library().smj_chunk_gated_merge_tile() != GATE_TILE:
        raise RuntimeError("chunk_gated_merge: the kernel's tile is not "
                           f"GATE_TILE = {GATE_TILE}")
    _build.launch("K9", "smj_chunk_gated_merge", landing, landing.data_ptr(),
                  lens.data_ptr(), arrive.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), scratch.numel(), stats.data_ptr(),
                  landing.numel(), stride, chunk_elems, W, max_chunks, parts)
    return out, stats[:W], stats[W]


def peer_pairs_missing(mesh) -> list:
    """The ordered pairs of distinct cards of a CUDA mesh, by index, that
    cannot reach each other's memory (``torch.cuda.can_device_access_peer``
    false): K11's peer writes need every pair."""
    cards = [c.index for c in mesh.cards if c.type == "cuda"]
    return [(i, j) for i in cards for j in cards
            if i != j and not torch.cuda.can_device_access_peer(i, j)]


def _check_peers(mesh) -> None:
    missing = peer_pairs_missing(mesh)
    if missing:
        i, j = missing[0]
        raise ValueError(f"remote_pull_exchange_merge: cuda:{i} cannot "
                         f"reach cuda:{j}'s memory (no peer access; pairs "
                         f"{missing}): K11 pushes by peer writes")


def _checked_pull(mesh, bflat, recv_counts, cap: int, chunk_elems: int,
                  window) -> int:
    """Raise on what K11 does not take (the JAX wrapper's asserts,
    remote_fifo.py:374-375, less its TPU tiling; a pair of the mesh's
    cards without peer access); return the send window K = min(window,
    pushes a shard), ``window`` defaulting to :func:`push_window`."""
    from .mesh import is_2d

    n = mesh.n
    if is_2d(mesh):
        raise ValueError("remote_pull_exchange_merge: a 2-D mesh; the push "
                         "walk runs over one flat axis")
    if n < 2 or n & (n - 1) or n > PULL_MAX_SHARDS:
        raise ValueError(f"remote_pull_exchange_merge: {n} shards; the "
                         f"mesh must be a power of two in [2, "
                         f"{PULL_MAX_SHARDS}]")
    if cap < 1 or chunk_elems < 1 or cap % chunk_elems:
        raise ValueError(f"remote_pull_exchange_merge: strips of {cap} keys "
                         f"do not hold whole chunks of {chunk_elems}")
    mesh.check_rows(bflat, "remote_pull_exchange_merge: bflat", n * cap)
    mesh.check_rows(recv_counts, "remote_pull_exchange_merge: recv_counts", n)
    _check_peers(mesh)
    if window is None:
        window = push_window()
    if int(window) < 1:
        raise ValueError(f"remote_pull_exchange_merge: window {window} < 1")
    return min(int(window), n * (cap // chunk_elems))


def _oversize(cap: int) -> ValueError:
    return ValueError(f"remote_pull_exchange_merge: a received count lies "
                      f"outside [0, {cap}]: the landing strip is too small "
                      "(never clamped)")


def remote_pull_exchange_merge_plain(mesh, bflat, recv_counts, cap: int,
                                     chunk_elems: int, window=None):
    """Plain version of K11: every shard's pushes, full chunks in the JAX
    kernel's order (:func:`push_schedule` over whole strips), copied into
    the landing strips one after another, so the send window changes
    nothing; then each shard's strips merged by
    :func:`chunk_gated_merge_plain` with every chunk delivered at round 0,
    which reports ``chunks_needed`` per strip and a zero flag.  Takes and
    returns per-shard values of either mesh layout."""
    _checked_pull(mesh, bflat, recv_counts, cap, chunk_elems, window)
    if any(mesh.tolist(mesh.map(
            lambda c: ((c < 0) | (c > cap)).any(-1), recv_counts))):
        raise _oversize(cap)
    n = mesh.n
    landing = mesh.empty_like(bflat)
    for me in range(n):
        for p in push_schedule(n, me, [cap] * n, chunk_elems):
            at = me * cap + p.start
            landing[p.dst][at:at + p.size].copy_(
                bflat[me][p.dst * cap + p.start:
                          p.dst * cap + p.start + p.size])
    arrive = np.zeros((n, cap // chunk_elems), np.int32)
    out = [chunk_gated_merge_plain(landing[d], recv_counts[d], cap,
                                   chunk_elems, arrive) for d in range(n)]
    return (mesh.stack(o[0] for o in out), mesh.stack(o[1] for o in out),
            mesh.stack(o[2] for o in out), landing)


def remote_pull_exchange_merge(mesh, bflat, recv_counts, cap: int,
                               chunk_elems: int, window=None):
    """The remote pull of one relation over a flat mesh of n shards (n a
    power of two >= 2): every shard pushes its n buckets, chunk by chunk,
    into its peers' landing strips while every shard merges its strips as
    they arrive.  Arguments and results are per-shard values of the mesh
    (``parallel/mesh.py``: stacks on a one-device mesh, one tensor a shard
    otherwise).

    ``bflat``       -- ``(n*cap,)`` int32 a shard, bucket d of shard me at
                       ``bflat[me][d*cap:(d+1)*cap]`` (the
                       ``dist_mway._cut_all`` layout), pads past each
                       bucket's count.
    ``recv_counts`` -- ``(n,)`` int32 a shard: shard d's strip r holds
                       ``recv_counts[d][r]`` live keys (the counts after
                       their small all-to-all); a count outside [0, cap]
                       raises (the JAX test plan's step 5), never clamps.
    ``window``      -- pushes in flight per shard: push i of a shard waits
                       for its push i - K (``SMJ_REMOTE_WINDOW`` by
                       default, :func:`push_window`).
    Returns ``(merged, waited, violation, landing)``, a shard each: the
    merged column ``(n*cap,)`` (INT32_MAX past its live total), the chunks
    its reader waited for per strip ``(n,)`` (ceil(count / chunk_elems),
    the JAX ``expected_sem_waits``), a flag that is set if its merge read
    past what it waited for, and its landing ``(n*cap,)``: the all-to-all
    of the buckets.  On a CUDA mesh it launches K11 once a card and reads
    two status words a card back after the last launch (the one host sync
    of the call); a pair of cards without peer access raises
    ``ValueError``; on a CPU mesh it takes the plain version."""
    if mesh.device.type == "cpu":
        return remote_pull_exchange_merge_plain(mesh, bflat, recv_counts,
                                                cap, chunk_elems, window)
    K = _checked_pull(mesh, bflat, recv_counts, cap, chunk_elems, window)
    return _pull_launch(mesh, bflat, recv_counts, cap, chunk_elems, K)


def _enable_peers(cards: list) -> None:
    """Peer access for every ordered pair of ``cards``: first through a
    one-word copy each way, which enables it in PyTorch's caching allocator
    too (so that memory it maps later stays reachable), then by the
    library, which takes access already enabled as done."""
    for a in cards:
        for b in cards:
            if a != b and (a.index, b.index) not in _PEERS:
                torch.zeros(1, device=b).copy_(torch.zeros(1, device=a))
                _build.check("smj_enable_peer_access", _build.library()
                             .smj_enable_peer_access(a.index, b.index))
                _PEERS.add((a.index, b.index))


def _join_streams(cards: list) -> None:
    """Order each card's current stream after the work queued so far on
    every other card's."""
    events = []
    for c in cards:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(c))
        events.append(ev)
    for c in cards:
        stream = torch.cuda.current_stream(c)
        for o, ev in zip(cards, events):
            if o != c:
                stream.wait_event(ev)


def _pull_launch(mesh, bflat, recv_counts, cap: int, chunk_elems: int,
                 window: int, landing=None):
    """K11 on checked inputs: one launch a card, every card's launch
    ordered after the work queued on every card and issued before any
    host read, and every card's later work ordered after every launch (a
    card's pushes write the other cards' landings and flags).  With
    ``landing`` (a full launch's) no push runs and every arrival flag is
    set before the launch, so the launch times the gated merge alone; the
    result is the full launch's."""
    n, chunks = mesh.n, cap // chunk_elems
    merge_only = landing is not None
    if not merge_only:
        landing = mesh.empty_like(bflat)
    merged = mesh.empty_like(bflat)
    cards = mesh.cards
    local = {c: [me for me in range(n) if mesh.device_of(me) == c]
             for c in cards}
    # each card's control words, then the flags of its shards as receivers
    scratch = {c: torch.zeros(_PULL_SCRATCH_HEAD + len(local[c]) * n * chunks,
                              dtype=torch.int32, device=c) for c in cards}
    if merge_only:
        for s in scratch.values():
            s[_PULL_SCRATCH_HEAD:] = 1
    stats = mesh.full((n + 1,), 0)  # a shard's waits, then its flag
    waited = mesh.map(lambda s: s[..., :n], stats)
    viol = mesh.map(lambda s: s[..., n], stats)
    # the table's rows in K11's Slot order: each shard's buffers, its
    # flags (its block of its card's scratch) and its card's control words
    table = np.empty((n, _PULL_TABLE_WORDS), np.int64)
    for k, x in enumerate((bflat, recv_counts, landing, merged, waited,
                           viol)):
        table[:, k] = mesh.row_ptrs(x)
    for me in range(n):
        c = mesh.device_of(me)
        table[me, 7] = scratch[c].data_ptr()
        table[me, 6] = table[me, 7] + 4 * (_PULL_SCRATCH_HEAD + local[c]
                                           .index(me) * n * chunks)
    tables = {c: torch.from_numpy(np.concatenate(
        [table.reshape(-1), np.asarray(local[c], np.int64)])).to(c)
        for c in cards}
    if len(cards) > 1:
        _enable_peers(cards)
        _join_streams(cards)
    for c in cards:
        _build.launch("K11", "smj_remote_pull", scratch[c],
                      tables[c].data_ptr(), scratch[c].data_ptr(),
                      len(local[c]), cap, chunk_elems, n, window,
                      int(merge_only))
    if len(cards) > 1:
        _join_streams(cards)
    status = [scratch[c][2:4].tolist() for c in cards]
    if any(error for error, _ in status):
        raise RuntimeError("remote_pull_exchange_merge: a wait for an "
                           "arrival saw no push land for 1 s: K11 is "
                           "broken")
    if any(oversize for _, oversize in status):
        raise _oversize(cap)
    return merged, waited, viol, landing
