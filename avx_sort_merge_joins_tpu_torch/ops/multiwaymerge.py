"""K-way merge of sorted runs, keys only (kernel K2) or (key, payload) pairs
in lexicographic order (kernel K6), and the multiway sort built on it
(counterpart of
``avx_sort_merge_joins_tpu/ops/multiwaymerge.py:522-631,655-750``),
with the schedule that stops at two runs (``merge_levels_2runs``).

Layout: flat int32 columns whose run r starts at ``r * span`` and holds
``clip(total - r * span, 0, span)`` elements -- the TPU package's
uniform-lens formula, kept as plain arithmetic (the TPU needed it to fit run
lengths in SMEM; here it is simply the layout).  ``multiway_merge`` merges
each group of ``fanin`` consecutive runs into one run at ``g * fanin *
span``.  On CUDA tensors it launches ``csrc/multiway_merge.cu`` (merge-path
tiles: a co-rank search, then a tile merge in shared memory); on CPU
tensors it takes the plain version ``multiway_merge_plain``.  With
``lens=`` (an int32 device vector) and ``stride=`` it merges runs of any
lengths at a fixed stride, keys only or with payloads (the varlen K2 and
K6, plain version ``multiway_merge_varlen_plain``): the distributed
joins' merge of the runs each shard receives.

Before its tile merge the kernel writes co-rank rows, each run's share of
the outputs before each tile boundary, in two launches: the coarse
boundaries, every 32 tiles, by a search in device memory; the rest, up to
fan-in ``SAMPLED_MAX_FANIN``, from regular samples of the coarse windows
ranked and finished in shared memory, above it by the same search as the
coarse ones.  :func:`corank_rows_plain` is those rows' plain version.

The kernel merges in tiles of ``MERGE_TILE`` outputs.  Keys only, uniform
or varlen, it also takes ``tile=`` 2,048 or 8,192 (``MERGE_TILES``): the
``-m`` merge-buffer size picks one through :func:`merge_tile_for`.  The
tile changes only how the kernel splits the work: every tile gives the
same columns.

The multiway sort's merge levels follow a named fan-in greedily, as the
JAX package's do; without one (``FANIN_DEFAULT``), keys and pairs alike,
the default plan of :func:`plan_fanins`, which takes one level fewer than
greedy at 16 where a first W = 32 level can take the place of a last
W = 2 one.  ``merge_level`` counts every level it runs under the
profiler counter ``K2_LEVELS``.

Every function takes the payload column as ``payloads=``; without it the
result is one key column, with it a ``(keys, payloads)`` tuple of columns.

TPU workarounds dropped: the ``(rows, 128)`` tiles and ``return_2d``, the
FIFO-tree tile and window sizes, and the spare window tile past the data.
Columns carry a logical length ``n``; slots from ``n`` on hold the
INT32_MAX pad, on both columns of a pair.
"""

from __future__ import annotations

import torch

from ..kernels import _build
from ..params import BLOCKSIZE_DEFAULT
from ..utils import profiling
from . import sort as sort_ops

MAX_FANIN = 2048  # the keys' largest fan-in (kMaxFanin)
MAX_PAIR_FANIN = 1024  # the pairs' (kMaxPairFanin)
MERGE_TILE = 4096  # outputs a merge tile (smj_mp::kTile): K6 and the default
MERGE_TILES = (2048, 4096, 8192)  # the tiles of the keys-only K2
SAMPLED_MAX_FANIN = 32  # the sampled fine co-ranks' largest fan-in
JAX_FANIN = 16  # the JAX package's fan-in: the default plan's greedy base
FANIN_DEFAULT = None  # no fan-in named: each sort's levels from plan_fanins
K2_LEVELS = "smj.k2.levels"  # the counter of the levels merge_level runs


def greedy_fanin(fanin: int | None) -> int:
    """The fan-in of a greedy merge where ``fanin`` may be None: the named
    one, else ``JAX_FANIN``.  The merges that keep the JAX package's
    schedule whatever the default (the varlen merges of received runs, the
    two-run schedule) take their fan-in from here."""
    return JAX_FANIN if fanin is None else fanin


def widest_fanin(fanin: int | None) -> int:
    """The widest level's fan-in of a multiway sort at ``fanin``: the named
    one, else the default plan's widest, ``SAMPLED_MAX_FANIN``."""
    return SAMPLED_MAX_FANIN if fanin is None else fanin


def merge_smem_bytes(tile: int, fanin: int) -> int:
    """Shared memory of one keys-only K2 merge CTA at ``tile`` outputs and
    fan-in ``fanin`` (``merge_smem<int, tile>`` of csrc/multiway_merge.cu):
    two int32 buffers of ``tile + tile / 32`` slots (one spare slot every
    32 against bank conflicts), an int64 segment start and an int32
    segment offset a run, and one more offset."""
    return 2 * 4 * (tile + tile // 32) + 8 * fanin + 4 * (fanin + 1)


def merge_tile_for(mwaybufsize_bytes: int, fanin: int | None) -> int:
    """The K2 merge tile that a ``-m`` budget of ``mwaybufsize_bytes``
    names at fan-in ``fanin``: the largest tile of ``MERGE_TILES`` whose
    footprint, :func:`merge_smem_bytes` (one merge CTA's shared memory),
    fits the budget; the smallest when none fits; ``MERGE_TILE`` for 0
    (the flag's default: derived).  This is the map the JAX m-way makes
    from the same budget to its FIFO tile (models/mway.py:206-216: the
    largest tile whose ring buffers fit, the smallest otherwise); only
    the tile changes, never the result.  ``fanin`` None (the planned
    levels) sizes the footprint at their widest (:func:`widest_fanin`)."""
    if not mwaybufsize_bytes:
        return MERGE_TILE
    widest = widest_fanin(fanin)
    fits = [t for t in MERGE_TILES
            if merge_smem_bytes(t, widest) <= mwaybufsize_bytes]
    return fits[-1] if fits else MERGE_TILES[0]


def _check_tile(tile: int, payloads) -> None:
    if tile not in MERGE_TILES:
        raise ValueError(f"multiway_merge: tile {tile} is not one of "
                         f"{MERGE_TILES}")
    if payloads is not None and tile != MERGE_TILE:
        raise ValueError(f"multiway_merge: pairs merge at tiles of "
                         f"{MERGE_TILE} only, got {tile}")


def _check_uniform(keys: torch.Tensor, payloads, fanin: int,
                   uniform_lens) -> None:
    sort_ops.check_uniform_lens(keys, uniform_lens, "multiway_merge")
    if payloads is not None:
        sort_ops._check_payloads(keys, payloads, 0, "multiway_merge")
    if fanin < 2 or fanin & (fanin - 1):
        raise ValueError(f"multiway_merge: fanin {fanin} is not a power of 2")


def multiway_merge_plain(keys: torch.Tensor, fanin: int, uniform_lens,
                         payloads: torch.Tensor | None = None):
    """Plain version of K2 and K6: ``torch.sort`` of each group's slice (of
    the packed pairs when there are payloads)."""
    _, total, span = uniform_lens
    if payloads is None:
        return sort_ops.sorted_groups(keys, total, fanin * span)
    return sort_ops.unpack_pairs(sort_ops.sorted_groups(
        sort_ops.pack_pairs(keys, payloads), total, fanin * span))


def _check_varlen(keys: torch.Tensor, fanin: int, lens: torch.Tensor,
                  stride, payloads) -> None:
    if payloads is not None:
        sort_ops._check_payloads(keys, payloads, 0, "multiway_merge")
    if fanin < 2 or fanin & (fanin - 1):
        raise ValueError(f"multiway_merge: fanin {fanin} is not a power of 2")
    sort_ops.check_lens(keys, lens, stride, fanin, "multiway_merge")


def multiway_merge_varlen_plain(keys: torch.Tensor, fanin: int,
                                lens: torch.Tensor, stride: int,
                                payloads: torch.Tensor | None = None):
    """Plain version of the varlen K2 and K6 (``sort.varlen_groups_plain``):
    each group's sorted elements at its region's start."""
    out, out_p, glen = sort_ops.varlen_groups_plain(keys, fanin, lens,
                                                    stride, payloads)
    return (out if payloads is None else (out, out_p)), glen


def corank_rows_plain(keys: torch.Tensor, fanin: int, uniform_lens=None,
                      payloads: torch.Tensor | None = None, *,
                      lens: torch.Tensor | None = None,
                      stride: int | None = None,
                      tile: int = MERGE_TILE) -> torch.Tensor:
    """Plain version of K2's and K6's co-rank rows: an int64 tensor of
    shape ``(ngroups, tpg + 1, fanin)``, ``tpg = cdiv(fanin * stride,
    tile)``, whose ``[g, t, r]`` is how many of run r's elements are
    among the first ``min(t * tile, live_g)`` outputs of group g's merge,
    ties to the lower run (the scratch rows the kernel's co-rank launches
    write).  Layouts as :func:`multiway_merge`'s: ``uniform_lens`` or
    ``lens=`` with ``stride=``.  From a stable sort of every group's live
    elements by value, laid out run after run: ties keep run order."""
    if lens is None:
        nruns, total, stride = uniform_lens
        ngroups = sort_ops.cdiv(nruns, fanin)
        starts = torch.arange(ngroups * fanin, dtype=torch.int64,
                              device=keys.device) * stride
        run_lens = (total - starts).clamp(0, stride)
    else:
        ngroups = lens.numel() // fanin
        run_lens = lens.to(torch.int64).clamp(0, stride)
    tpg = sort_ops.cdiv(fanin * stride, tile)
    nr = ngroups * fanin
    run = torch.repeat_interleave(
        torch.arange(nr, dtype=torch.int64, device=keys.device), run_lens)
    first = torch.cumsum(run_lens, 0) - run_lens
    idx = run * stride + (torch.arange(run.numel(), dtype=torch.int64,
                                       device=keys.device) - first[run])
    vals = keys[idx].to(torch.int64) if payloads is None else \
        sort_ops.pack_pairs(keys[idx], payloads[idx])
    # grouped, then by value within a group, then run and position
    order = torch.sort(vals, stable=True).indices
    order = order[torch.sort(run[order] // fanin, stable=True).indices]
    group = run[order] // fanin
    glive = run_lens.view(ngroups, fanin).sum(1)
    rank = torch.arange(order.numel(), dtype=torch.int64,
                        device=keys.device) - (torch.cumsum(glive, 0) -
                                               glive)[group]
    # an output of rank k is before boundary t once t * tile > k
    rows = torch.zeros((ngroups, tpg + 1, fanin), dtype=torch.int64,
                       device=keys.device)
    rows.index_put_((group, rank // tile + 1, run[order] % fanin),
                    torch.ones_like(rank), accumulate=True)
    return rows.cumsum(1)


def corank_fallbacks(device, reset: bool = False) -> int:
    """Fine co-rank boundaries on ``device``'s card whose sampled brackets
    overflowed their shared-memory stage since the last reset (the
    kernel's bound says none can), ``reset`` zeroing the count.  It
    synchronises: for the tests and the smoke, never the join's path."""
    with torch.cuda.device(device):
        n = _build.library().smj_corank_fallbacks(int(reset))
    if n < 0:
        raise RuntimeError("smj_corank_fallbacks: reading the count failed")
    return int(n)


def corank_scratch(keys: torch.Tensor, ngroups: int, stride: int,
                   fanin: int, tile: int = MERGE_TILE) -> torch.Tensor:
    """The co-rank scratch of one K2 or K6 call on the keys' card, at tiles
    of ``tile`` outputs."""
    size = _build.library().smj_multiway_merge_scratch(ngroups, stride,
                                                       fanin, tile)
    return torch.empty(size, dtype=torch.int64, device=keys.device)


def _launch(entry: str, keys: torch.Tensor, payloads, ngroups: int,
            stride: int, fanin: int, *layout, parts: int = 7,
            scratch: torch.Tensor | None = None, tile: int = MERGE_TILE):
    """One K2 (payloads None) or K6 call of ``entry`` into fresh columns;
    ``layout`` are the entry point's arguments between the output size and
    the fan-in.  ``parts``, a mask of 1 (coarse co-ranks), 2 (fine
    co-ranks) and 4 (the tile merge, on the co-ranks ``scratch`` holds),
    picks the launches, for timing each; ``tile`` the outputs a merge
    tile.  Counted as "K2" and "K2.tile<tile>", or "K6", and "K2.search"
    when the fine co-ranks keep the search in device memory (fan-in above
    ``SAMPLED_MAX_FANIN``)."""
    most = MAX_FANIN if payloads is None else MAX_PAIR_FANIN
    if fanin > most:
        raise ValueError(f"multiway_merge: the kernel takes a fanin of at "
                         f"most {most}, got {fanin}")
    if scratch is None:
        scratch = corank_scratch(keys, ngroups, stride, fanin, tile)
    out_k = torch.empty_like(keys)
    out_p = None if payloads is None else torch.empty_like(payloads)
    ids = ("K2", f"K2.tile{tile}") if payloads is None else ("K6",)
    if parts & 2 and fanin > SAMPLED_MAX_FANIN:
        ids += ("K2.search",)
    _build.launch(ids, entry, keys, keys.data_ptr(),
                  None if payloads is None else payloads.data_ptr(),
                  out_k.data_ptr(),
                  None if out_p is None else out_p.data_ptr(),
                  scratch.data_ptr(), scratch.numel(), keys.numel(), *layout,
                  fanin, tile, parts)
    return out_k if payloads is None else (out_k, out_p)


def _multiway_merge_varlen(keys: torch.Tensor, fanin: int,
                           lens: torch.Tensor, stride: int, payloads,
                           tile: int):
    _check_varlen(keys, fanin, lens, stride, payloads)
    _check_tile(tile, payloads)
    if keys.device.type == "cpu":
        return multiway_merge_varlen_plain(keys, fanin, lens, stride,
                                           payloads)
    merged = _launch("smj_multiway_merge_varlen", keys, payloads,
                     lens.numel() // fanin, stride, fanin, lens.data_ptr(),
                     lens.numel(), stride, tile=tile)
    return merged, lens.view(-1, fanin).clamp(0, stride).sum(
        1, dtype=torch.int32)


def multiway_merge(keys: torch.Tensor, fanin: int, uniform_lens=None,
                   payloads: torch.Tensor | None = None, *,
                   lens: torch.Tensor | None = None,
                   stride: int | None = None, tile: int = MERGE_TILE):
    """Merge groups of ``fanin`` consecutive ascending runs.

    ``uniform_lens=(nruns, total, span)``: run r starts at ``r * span`` with
    length ``clip(total - r * span, 0, span)``.  With ``payloads`` the runs
    are ascending in lexicographic (key, payload) order and merge in it.
    Returns ``(merged, new_lens)``: merged run g starts at ``g * fanin *
    span`` with length ``new_lens[g]``; ``merged`` (a column, or a ``(keys,
    payloads)`` tuple) has as many slots as ``keys``, and slots from
    ``total`` on hold INT32_MAX.

    Varlen mode (``lens=``, ``stride=``), keys only or with ``payloads``:
    run r starts at ``r * stride`` and holds ``lens[r]`` elements, ``lens``
    an int32 tensor on the keys' device whose length is a multiple of
    ``fanin`` (the dynamic-lens mode of the JAX ``multiway_merge``,
    ops/multiwaymerge.py:522-560).  Merged group g starts at ``g * fanin *
    stride``; every slot past a group's live elements holds INT32_MAX, on
    both columns.  ``new_lens`` is then the group sums as an int32 tensor
    on the device: no host sync.

    ``tile``: outputs a merge tile of the kernel, one of ``MERGE_TILES``
    for keys, ``MERGE_TILE`` for pairs; the columns do not depend on it.
    """
    if lens is not None:
        if uniform_lens is not None:
            raise ValueError("multiway_merge: lens= takes no uniform_lens")
        return _multiway_merge_varlen(keys, fanin, lens, stride, payloads,
                                      tile)
    _check_uniform(keys, payloads, fanin, uniform_lens)
    _check_tile(tile, payloads)
    nruns, total, span = uniform_lens
    ngroups = sort_ops.cdiv(nruns, fanin)
    new_lens = [max(0, min(total - g * fanin * span, fanin * span))
                for g in range(ngroups)]
    if keys.device.type == "cpu":
        return multiway_merge_plain(keys, fanin, uniform_lens,
                                    payloads), new_lens
    return _launch("smj_multiway_merge", keys, payloads, ngroups, span,
                   fanin, total, span, tile=tile), new_lens


def sort_blocks_phase(keys: torch.Tensor, n: int,
                      block: int = BLOCKSIZE_DEFAULT,
                      payloads: torch.Tensor | None = None):
    """Phase 1 of the multiway sort: sort each ``block``-element block
    ascending (the in-cache sort of partitions,
    sortmergejoin_multiway.c:388-460), K1 for keys and K5 for pairs.
    Returns the flat padded column(s) of ``max(1, cdiv(n, block)) * block``
    slots."""
    if payloads is None:
        return sort_ops.sort_blocks(keys, n, block)
    return sort_ops.sort_blocks_pairs(keys, payloads, n, block)


def _greedy_fanins(nruns: int, fanin: int) -> list[int]:
    """Fan-in ``fanin`` a level until one run is left, the last level no
    wider than the runs it merges (the JAX package's schedule)."""
    fanins = []
    while nruns > 1:
        w = min(fanin, 1 << (nruns - 1).bit_length())
        fanins.append(w)
        nruns = -(-nruns // w)
    return fanins


def plan_fanins(nruns: int) -> list[int]:
    """The fan-ins of the default plan of a sort of ``nruns`` runs: the
    greedy plan at ``JAX_FANIN``, except that where it would end in a W = 2
    level after others, that round joins the first level, which merges
    ``SAMPLED_MAX_FANIN`` runs: the same ceil(log2 nruns) rounds in one
    level fewer.  Every level pays one read and write of the column and a
    co-rank pass before its rounds; a W = 32 level pays more co-rank and
    one more round than a W = 16 one, which one W = 2 level saved pays
    back and a second W = 32 level does not (``PERF.md`` §6, keys and
    pairs alike): 7,813 runs (128M) merge at 32, 16, 16, 125,000 at 32,
    16, 16, 16, and 12,208 (a 200M-key shard) at 16, 16, 16, 4, as
    greedily at 16."""
    fanins = _greedy_fanins(nruns, JAX_FANIN)
    if len(fanins) > 1 and fanins[-1] == 2:
        fanins = [2 * fanins[0], *fanins[1:-1]]
    return fanins


def _levels(nruns: int, block: int, fanins):
    """The ``(stride, span, nruns, w)`` levels that merge ``nruns`` runs of
    ``block`` at ``fanins`` in turn, the span and the runs left."""
    stride, span = block, block
    levels = []
    for w in fanins:
        levels.append((stride, span, nruns, w))
        stride *= w
        span *= w
        nruns = -(-nruns // w)
    return levels, span, nruns


def merge_levels(n: int, block: int, fanin: int | None = FANIN_DEFAULT):
    """Static ``(stride, span, nruns, w)`` schedule of the k-way merge
    levels of an n-key multiway sort, in keys (the TPU package gives
    ``stride`` in 128-key rows; here ``stride == span``): greedy at a
    named ``fanin``, the JAX package's schedule; without one the default
    plan, :func:`plan_fanins`."""
    nruns = max(1, sort_ops.cdiv(n, block))
    fanins = (plan_fanins(nruns) if fanin is None
              else _greedy_fanins(nruns, fanin))
    return _levels(nruns, block, fanins)[0]


def merge_levels_2runs(n: int, block: int,
                       fanin: int | None = FANIN_DEFAULT):
    """The level schedule that stops at TWO runs instead of one (counterpart
    of ``avx_sort_merge_joins_tpu/ops/multiwaymerge.py:698-717``): the
    last merge is left to the two-run count (K10,
    ``mergejoin.merge_join_count_fused2``).  Where a level's fan-in would
    finish at one run, it is halved so that two groups remain; greedy at
    :func:`greedy_fanin`.  Returns ``(levels, final_span, final_nruns)``,
    sizes in keys, with ``final_nruns`` 1 (a single block: the caller takes
    the one-run count) or 2."""
    fanin = greedy_fanin(fanin)
    nruns = max(1, sort_ops.cdiv(n, block))
    fanins, left = [], nruns
    while left > 2:
        w = min(fanin, 1 << (left - 1).bit_length())
        if w >= left:
            w = max(2, (1 << (left - 1).bit_length()) // 2)
        fanins.append(w)
        left = -(-left // w)
    return _levels(nruns, block, fanins)


def merge_level(keys: torch.Tensor, n: int, level,
                payloads: torch.Tensor | None = None,
                tile: int = MERGE_TILE):
    """One k-way merge level over the uniform-lens layout, counted under
    ``K2_LEVELS``."""
    _, span, nruns, w = level
    profiling.count(K2_LEVELS)
    merged, _ = multiway_merge(keys, w, (nruns, n, span), payloads,
                               tile=tile)
    return merged


def multiway_sort(keys: torch.Tensor, n: int | None = None,
                  block: int = BLOCKSIZE_DEFAULT,
                  fanin: int | None = FANIN_DEFAULT,
                  payloads: torch.Tensor | None = None,
                  tile: int = MERGE_TILE):
    """Full ascending sort of ``keys[:n]``, or of the first ``n`` (key,
    payload) pairs in lexicographic order: block sort, then the k-way merge
    levels of :func:`merge_levels` (avxsort_multiway.c:96-152), greedy at
    a named ``fanin``, else the default plan; keys only at merge tiles of
    ``tile`` outputs.  Returns the flat padded column(s); the live prefix
    is ``[:n]``."""
    if n is None:
        n = int(keys.numel())
    if payloads is None:
        ks = sort_blocks_phase(keys, n, block)
        for level in merge_levels(n, block, fanin):
            ks = merge_level(ks, n, level, tile=tile)
        return ks
    ks, ps = sort_blocks_phase(keys, n, block, payloads)
    for level in merge_levels(n, block, fanin):
        ks, ps = merge_level(ks, n, level, ps)
    return ks, ps
