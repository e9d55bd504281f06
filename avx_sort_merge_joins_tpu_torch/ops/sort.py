"""Block sorts (kernels K1 and K5), the pairwise merge pass (kernel K4) and
the sort built on them (counterpart of
``avx_sort_merge_joins_tpu/ops/sort.py:86-145,279-527``).

* ``sort_blocks`` sorts each ``block``-key block of a flat int32 column
  ascending (K1, ``csrc/block_sort.cu``).
* ``sort_blocks_pairs`` sorts each block of (key, payload) pairs in
  lexicographic order, every block ascending or every block descending
  (K5, ``csrc/block_sort_pairs.cu``).
* ``merge_pass`` merges the run pairs (2j, 2j+1) of a uniform-lens layout
  into runs of twice the length, keys only or pairs (K4,
  ``csrc/merge_pass.cu``, merge-path tiles); with ``lens=`` (an int32
  device vector) and ``stride=`` it merges ascending runs of any lengths at
  a fixed stride (the varlen mode, the JAX ``merge_pass`` with a traced
  ``lens`` and ``b_asc``).
* ``sort``/``sort_descending``: K5, then log2(#blocks) K4 passes;
  ``sort_torch`` is one ``torch.sort`` of the packed pairs, the
  ``--scalarsort`` baseline and yardstick.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it
takes its plain PyTorch version (``*_plain``).  Pairs compare as one int64
(``pack_pairs``): the key in the high half, the payload with its sign bit
flipped in the low half, the kernels' ``smj_pack``.

The uniform-lens layout: run r starts at ``r * span`` and holds
``clip(total - r * span, 0, span)`` elements, slots from ``total`` on hold
the pad that sorts last.  TPU workarounds dropped here: the ``(rows, 128)``
tiling with ``prepare``/``padded_rows`` and their spare window rows
(columns are flat), the alternating ascending/descending block directions
with ``flip`` and the (asc, desc) run pairs with ``b_asc`` of the merge
pass (Mosaic has no reverse; here every run goes the output's direction),
and the 65,536-key block, which was a VMEM size and does not fit in shared
memory.
"""

from __future__ import annotations

import torch

from ..kernels import _build
from ..params import BLOCKSIZE_DEFAULT
from .bitonic import KEY_NEG_INF, KEY_POS_INF

# block sizes the block sorts take: powers of two whose keys (K1) or pairs
# (K5, 128 KB at 16,384) fit in shared memory and give every thread of the
# CTA at least one compare-exchange
SUPPORTED_BLOCKS = (1024, 2048, 4096, 8192, 16384)

_LOW_HALF = 1 << 32  # the payload half of a packed pair


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_keys(keys: torch.Tensor, n: int, name: str) -> None:
    if keys.dtype != torch.int32:
        raise TypeError(f"{name}: keys must be int32, got {keys.dtype}")
    if keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(f"{name}: keys must be a contiguous 1-D tensor")
    if not 0 <= n <= keys.numel():
        raise ValueError(f"{name}: n={n} outside [0, {keys.numel()}]")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {keys.device}")


def _check_payloads(keys: torch.Tensor, payloads: torch.Tensor, n: int,
                    name: str) -> None:
    _check_keys(payloads, n, name)
    if payloads.shape != keys.shape or payloads.device != keys.device:
        raise ValueError(f"{name}: payloads {tuple(payloads.shape)} on "
                         f"{payloads.device} do not match keys "
                         f"{tuple(keys.shape)} on {keys.device}")


def check_uniform_lens(keys: torch.Tensor, uniform_lens, name: str) -> None:
    """Raise unless ``(nruns, total, span)`` describes a uniform-lens
    layout inside ``keys``."""
    _check_keys(keys, 0, name)
    nruns, total, span = uniform_lens
    if span < 1 or not 0 <= total <= keys.numel():
        raise ValueError(f"{name}: bad span {span} / total {total} "
                         f"for {keys.numel()} slots")
    if nruns != max(1, cdiv(total, span)):
        raise ValueError(f"{name}: {nruns} runs of span {span} "
                         f"cannot hold exactly {total} keys")


def check_lens(keys: torch.Tensor, lens, stride, group: int,
               name: str) -> None:
    """Raise unless ``lens`` is a contiguous 1-D int32 tensor on the keys'
    device whose runs, ``stride`` slots apart, make whole groups of
    ``group`` and fit in ``keys`` (the varlen layout)."""
    _check_keys(keys, 0, name)
    if not isinstance(lens, torch.Tensor) or lens.dtype != torch.int32 \
            or lens.dim() != 1 or lens.device != keys.device \
            or not lens.is_contiguous():
        raise ValueError(f"{name}: lens must be a contiguous 1-D int32 "
                         f"tensor on {keys.device}")
    if stride is None or stride < 1:
        raise ValueError(f"{name}: lens needs a stride >= 1, got {stride}")
    if lens.numel() == 0 or lens.numel() % group:
        raise ValueError(f"{name}: {lens.numel()} runs are not whole "
                         f"groups of {group}")
    if keys.numel() < lens.numel() * stride:
        raise ValueError(f"{name}: {keys.numel()} slots hold fewer than "
                         f"{lens.numel()} runs of stride {stride}")


def varlen_groups_plain(keys: torch.Tensor, group: int, lens: torch.Tensor,
                        stride: int, payloads: torch.Tensor | None = None):
    """Plain version of a merge of each ``group`` consecutive runs of the
    varlen layout (run r at ``r * stride``, ``clip(lens[r], 0, stride)``
    elements, ascending): one ``torch.sort`` of the live keys (or packed
    pairs), then a stable one of their groups; each group's sorted
    elements go to its region's start, every other slot is INT32_MAX (on
    both columns).  Returns ``(keys, payloads or None, group_lens)``."""
    dev = keys.device
    nruns = lens.numel()
    ln = lens.to(torch.int64).clamp(0, stride)
    slot = torch.arange(nruns * stride, dtype=torch.int64, device=dev)
    run = slot // stride
    live = slot - run * stride < ln[run]
    vals = keys[:nruns * stride][live].to(torch.int64)
    if payloads is not None:
        vals = pack_pairs(vals, payloads[:nruns * stride][live])
    vals, order = torch.sort(vals)
    gsorted, order = torch.sort(run[live][order] // group, stable=True)
    vals = vals[order]
    glen = ln.view(-1, group).sum(1)
    first = torch.cumsum(glen, 0) - glen  # live elements before each group
    rank = torch.arange(vals.numel(), dtype=torch.int64, device=dev) \
        - first[gsorted]
    at = gsorted * group * stride + rank
    out = torch.full_like(keys, KEY_POS_INF)
    if payloads is None:
        out[at] = vals.to(torch.int32)
        return out, None, glen.to(torch.int32)
    out_p = torch.full_like(payloads, KEY_POS_INF)
    out[at], out_p[at] = unpack_pairs(vals)
    return out, out_p, glen.to(torch.int32)


def _padded(col: torch.Tensor, n: int, cap: int,
            fill: int = KEY_POS_INF) -> torch.Tensor:
    """col[:n] followed by ``fill`` up to ``cap`` slots."""
    out = torch.full((cap,), fill, dtype=col.dtype, device=col.device)
    out[:n] = col[:n]
    return out


def sorted_groups(col: torch.Tensor, total: int, group: int,
                  descending: bool = False) -> torch.Tensor:
    """``torch.sort`` of each ``group``-slot slice of ``col[:total]``,
    padded to ``col``'s length with the value that sorts last: the plain
    version of a merge of the runs inside each group."""
    fill = _pad_of(col.dtype, descending)
    ngroups = max(1, cdiv(total, group))
    live = _padded(col, total, ngroups * group, fill).view(-1, group).sort(
        dim=1, descending=descending).values.reshape(-1)[:total]
    return _padded(live, total, col.numel(), fill)


# --------------------------------------------------------------------------
# packed pairs
# --------------------------------------------------------------------------

def pack_pairs(keys: torch.Tensor, payloads: torch.Tensor) -> torch.Tensor:
    """int32 (key, payload) pairs as int64s whose order is the pairs'
    lexicographic order; (INT32_MAX, INT32_MAX) packs to the int64 max and
    (INT32_MIN, INT32_MIN) to the int64 min."""
    return (keys.to(torch.int64) * _LOW_HALF
            + (payloads.to(torch.int64) - KEY_NEG_INF))


def unpack_pairs(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return ((packed >> 32).to(torch.int32),
            ((packed & (_LOW_HALF - 1)) + KEY_NEG_INF).to(
                torch.int32))


def _pad_of(dtype: torch.dtype, descending: bool) -> int:
    """The key (int32) or packed pair (int64) that sorts last."""
    info = torch.iinfo(dtype)
    return info.min if descending else info.max


# --------------------------------------------------------------------------
# K1: block sort, keys only
# --------------------------------------------------------------------------

def sort_blocks_plain(keys: torch.Tensor, n: int,
                      block: int = BLOCKSIZE_DEFAULT) -> torch.Tensor:
    """Plain version of K1: ``torch.sort`` of each block row."""
    nblocks = max(1, cdiv(n, block))
    return _padded(keys, n, nblocks * block).view(-1, block).sort(
        dim=1).values.reshape(-1)


def _check_block(block: int, name: str) -> None:
    if block not in SUPPORTED_BLOCKS:
        raise ValueError(f"{name}: block {block} not in {SUPPORTED_BLOCKS}")


def sort_blocks(keys: torch.Tensor, n: int,
                block: int = BLOCKSIZE_DEFAULT) -> torch.Tensor:
    """Sort ``keys[:n]`` in ascending blocks of ``block`` keys.

    Returns a new flat int32 tensor of ``max(1, cdiv(n, block)) * block``
    keys: block b holds the sorted keys[b*block : (b+1)*block], and the
    ragged last block ends in INT32_MAX pads.
    """
    _check_keys(keys, n, "sort_blocks")
    _check_block(block, "sort_blocks")
    if keys.device.type == "cpu":
        return sort_blocks_plain(keys, n, block)
    nblocks = max(1, cdiv(n, block))
    out = torch.empty(nblocks * block, dtype=torch.int32, device=keys.device)
    _build.launch("K1", "smj_block_sort", keys, keys.data_ptr(),
                  out.data_ptr(), n, block, nblocks)
    return out


# --------------------------------------------------------------------------
# K5: block sort of (key, payload) pairs
# --------------------------------------------------------------------------

def sort_blocks_pairs_plain(keys: torch.Tensor, payloads: torch.Tensor,
                            n: int, block: int = BLOCKSIZE_DEFAULT,
                            descending: bool = False):
    """Plain version of K5: ``torch.sort`` of each block row of the packed
    pairs."""
    fill = KEY_NEG_INF if descending else KEY_POS_INF
    cap = max(1, cdiv(n, block)) * block
    packed = pack_pairs(_padded(keys, n, cap, fill),
                        _padded(payloads, n, cap, fill))
    return unpack_pairs(packed.view(-1, block).sort(
        dim=1, descending=descending).values.reshape(-1))


def sort_blocks_pairs(keys: torch.Tensor, payloads: torch.Tensor, n: int,
                      block: int = BLOCKSIZE_DEFAULT,
                      descending: bool = False):
    """Sort the pairs ``(keys[i], payloads[i])``, i < n, in blocks of
    ``block`` pairs, lexicographically, every block ascending (or every
    block descending).

    Returns new flat int32 ``(keys, payloads)`` of ``max(1, cdiv(n,
    block)) * block`` slots; the ragged last block ends in (INT32_MAX,
    INT32_MAX) pads, or (INT32_MIN, INT32_MIN) when descending.
    """
    _check_keys(keys, n, "sort_blocks_pairs")
    _check_payloads(keys, payloads, n, "sort_blocks_pairs")
    _check_block(block, "sort_blocks_pairs")
    if keys.device.type == "cpu":
        return sort_blocks_pairs_plain(keys, payloads, n, block, descending)
    nblocks = max(1, cdiv(n, block))
    out_k = torch.empty(nblocks * block, dtype=torch.int32,
                        device=keys.device)
    out_p = torch.empty_like(out_k)
    _build.launch("K5", "smj_block_sort_pairs", keys, keys.data_ptr(),
                  payloads.data_ptr(), out_k.data_ptr(), out_p.data_ptr(), n,
                  block, nblocks, int(descending))
    return out_k, out_p


# --------------------------------------------------------------------------
# K4: pairwise merge pass
# --------------------------------------------------------------------------

def merge_pass_plain(keys: torch.Tensor, payloads: torch.Tensor | None,
                     uniform_lens=None, descending: bool = False, *,
                     lens: torch.Tensor | None = None,
                     stride: int | None = None):
    """Plain version of K4: ``torch.sort`` of each ``2 * span`` slice (of
    the packed pairs in pair mode); in the varlen mode ``torch.sort`` of
    each pair's live elements, pads after them
    (:func:`varlen_groups_plain`)."""
    if lens is not None:
        return varlen_groups_plain(keys, 2, lens, stride, payloads)
    _, total, span = uniform_lens
    if payloads is None:
        return sorted_groups(keys, total, 2 * span, descending), None
    return unpack_pairs(sorted_groups(pack_pairs(keys, payloads), total,
                                      2 * span, descending))


def _check_merge_pass(keys: torch.Tensor, payloads, uniform_lens,
                      descending: bool, lens, stride) -> None:
    if payloads is not None:
        _check_payloads(keys, payloads, 0, "merge_pass")
    if lens is None:
        if uniform_lens is None:
            raise ValueError("merge_pass: needs uniform_lens or lens=")
        check_uniform_lens(keys, uniform_lens, "merge_pass")
        nruns, _, span = uniform_lens
        if keys.numel() > cdiv(nruns, 2) * 2 * span:
            raise ValueError(f"merge_pass: {keys.numel()} slots reach past "
                             f"the last pair of {nruns} runs of span {span}")
        return
    if uniform_lens is not None or descending:
        raise ValueError("merge_pass: lens= merges ascending runs and takes "
                         "no uniform_lens")
    check_lens(keys, lens, stride, 2, "merge_pass")
    if keys.numel() != lens.numel() * stride:
        raise ValueError(f"merge_pass: {keys.numel()} slots are not the "
                         f"{lens.numel()} runs of stride {stride}")


def merge_pass(keys: torch.Tensor, payloads: torch.Tensor | None,
               uniform_lens=None, descending: bool = False, *,
               lens: torch.Tensor | None = None, stride: int | None = None):
    """One pass of pairwise run merges.

    ``uniform_lens=(nruns, total, span)``: run r starts at ``r * span``
    with length ``clip(total - r * span, 0, span)``, every run sorted in
    the pass's direction.  Runs 2j and 2j+1 merge into the run at
    ``2j * span``; a last run without a partner is copied.  With
    ``payloads`` the pairs merge in lexicographic order; ``payloads=None``
    merges keys only.  ``keys`` may not reach past the last pair's
    ``2 * span`` slots.  Returns new ``(keys, payloads or None)`` with as
    many slots as ``keys``; slots from ``total`` on hold the pad that
    sorts last (INT32_MAX ascending, INT32_MIN descending).

    Varlen mode (``lens=``, ``stride=``; the JAX ``merge_pass`` with a
    traced ``lens`` and ``b_asc=True``): run r starts at ``r * stride`` and
    holds ``clip(lens[r], 0, stride)`` elements, ascending; ``lens`` is an
    int32 tensor of even length on the keys' device, and ``keys`` holds
    exactly ``lens.numel() * stride`` slots.  Pair j merges into the run at
    ``2j * stride``; every slot past a pair's live elements holds
    INT32_MAX, on both columns.  Returns ``(keys, payloads or None,
    new_lens)``, ``new_lens = lens[0::2] + lens[1::2]`` (clipped as above)
    an int32 tensor on the device: no host sync.
    """
    _check_merge_pass(keys, payloads, uniform_lens, descending, lens,
                      stride)
    if keys.device.type == "cpu":
        return merge_pass_plain(keys, payloads, uniform_lens, descending,
                                lens=lens, stride=stride)
    out_k = torch.empty_like(keys)
    out_p = None if payloads is None else torch.empty_like(payloads)
    cols = (keys.data_ptr(), None if payloads is None else payloads.data_ptr(),
            out_k.data_ptr(), None if out_p is None else out_p.data_ptr())
    if lens is None:
        _, total, span = uniform_lens
        _build.launch("K4", "smj_merge_pass", keys, *cols, keys.numel(),
                      total, span, int(descending))
        return out_k, out_p
    _build.launch("K4", "smj_merge_pass_varlen", keys, *cols,
                  lens.data_ptr(), lens.numel(), stride)
    return out_k, out_p, lens.view(-1, 2).clamp(0, stride).sum(
        1, dtype=torch.int32)


def pair_levels(n: int, block: int):
    """``(nruns, span)`` of each pairwise merge pass of an n-element sort
    from ``block``-element runs: log2(#blocks) passes, the reference's
    halving loop (sortmergejoin_multipass.c:634-656)."""
    nruns, span = max(1, cdiv(n, block)), block
    levels = []
    while nruns > 1:
        levels.append((nruns, span))
        span *= 2
        nruns = cdiv(nruns, 2)
    return levels


# --------------------------------------------------------------------------
# composition
# --------------------------------------------------------------------------

def _sort_pairs(keys, payloads, n, block, descending):
    if n is None:
        n = int(keys.numel())
    ks, ps = sort_blocks_pairs(keys, payloads, n, block, descending)
    for nruns, span in pair_levels(n, block):
        ks, ps = merge_pass(ks, ps, (nruns, n, span), descending)
    return ks[:n], ps[:n]


def sort(keys: torch.Tensor, payloads: torch.Tensor, n: int | None = None,
         block: int = BLOCKSIZE_DEFAULT):
    """Sort the first ``n`` (key, payload) pairs lexicographically: K5,
    then log2(#blocks) K4 passes.  Returns the live ``(keys, payloads)``
    of length n.  The analog of avxsort_tuples (avxsort.h:36-44)."""
    return _sort_pairs(keys, payloads, n, block, False)


def sort_descending(keys: torch.Tensor, payloads: torch.Tensor,
                    n: int | None = None, block: int = BLOCKSIZE_DEFAULT):
    """The full descending sort of the first ``n`` pairs."""
    return _sort_pairs(keys, payloads, n, block, True)


def sort_torch(keys: torch.Tensor, payloads: torch.Tensor):
    """Baseline: one ``torch.sort`` of the packed pairs -- the
    'scalarsort' analog (reference: src/scalarsort/scalarsort.c) and the
    yardstick of ``sort``, never its path."""
    return unpack_pairs(torch.sort(pack_pairs(keys, payloads)).values)


def two_run_layout(ka: torch.Tensor, kb: torch.Tensor, na: int, nb: int,
                   pa=None, pb=None):
    """The uniform-lens layout of a 2-run merge: run A = ``ka[:na]`` at
    slot 0, run B = ``kb[:nb]`` at slot ``span = max(na, nb, 1)``.  ``pa``
    and ``pb`` fill the payload column: a column each (``pa[:na]``,
    ``pb[:nb]``), or an int each that every pair of the run gets (the
    tag-merge's source flags); None for keys only.  A's slots from ``na``
    to ``span`` hold the pad INT32_MAX (on both columns), which sorts after
    every real element, so the first ``na + nb`` merged elements are the
    real ones.  Both runs ascending.

    Returns ``(keys, payloads or None, uniform_lens)``.
    """
    span = max(na, nb, 1)
    total = span + nb
    keys = torch.full((total,), KEY_POS_INF, dtype=torch.int32,
                      device=ka.device)
    keys[:na] = ka[:na]
    keys[span:] = kb[:nb]
    payloads = None
    if pa is not None:
        payloads = torch.full_like(keys, KEY_POS_INF)
        payloads[:na] = pa if isinstance(pa, int) else pa[:na]
        payloads[span:] = pb if isinstance(pb, int) else pb[:nb]
    return keys, payloads, (max(1, cdiv(total, span)), total, span)
