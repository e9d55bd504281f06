"""The plain reference: the join's answers worked out again from the
benchmark's own relations, in plain PyTorch, by another method than the
program's (a histogram of R's keys, gathered at S's keys, where the
program sorts and merges).  It imports nothing of the program and reads
nothing the program made.

* ``count``: sum over keys of cntR(k) * cntS(k), in int64.
* ``rows``: every S tuple ``<key, payload>`` whose key R holds, once per
  matching R tuple, ascending by (key, payload): the materializing join's
  ``<S-key, S-RID>`` rows.

Both work a chunk of rows at a time, so that they fit beside the
relations on the device.
"""

from __future__ import annotations

import torch

CHUNK = 1 << 26


def _chunks(col: torch.Tensor):
    for lo in range(0, col.numel(), CHUNK):
        yield col[lo:lo + CHUNK]


def _key_range(*cols: torch.Tensor) -> tuple[int, int]:
    lo = min(int(c.min()) for c in cols)
    hi = max(int(c.max()) for c in cols)
    return lo, hi


def r_histogram(r_keys: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """int32 counts of R's keys over the key range [lo, hi]."""
    hist = torch.zeros(hi - lo + 1, dtype=torch.int32, device=r_keys.device)
    for part in _chunks(r_keys):
        hist.index_add_(0, part.long() - lo,
                        torch.ones_like(part, dtype=torch.int32))
    return hist


def count(r_keys: torch.Tensor, s_keys: torch.Tensor) -> int:
    """The exact match count of R and S."""
    lo, hi = _key_range(r_keys, s_keys)
    hist = r_histogram(r_keys, lo, hi)
    total = torch.zeros((), dtype=torch.int64, device=r_keys.device)
    for part in _chunks(s_keys):
        total += hist[part.long() - lo].sum(dtype=torch.int64)
    return int(total)


def pack(keys: torch.Tensor, payloads: torch.Tensor) -> torch.Tensor:
    """(key, payload) as one int64 whose order is the pairs' lexicographic
    order over signed int32 halves."""
    return (keys.long() << 32) | (payloads.long() + 2**31)


def unpack(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return ((packed >> 32).int(),
            ((packed & 0xFFFFFFFF) - 2**31).int())


def rows(r_keys: torch.Tensor, s_keys: torch.Tensor,
         s_payloads: torch.Tensor) -> torch.Tensor:
    """The matched rows, packed (:func:`pack`), in ascending order."""
    lo, hi = _key_range(r_keys, s_keys)
    hist = r_histogram(r_keys, lo, hi)
    kept, mults = [], []
    for k, p in zip(_chunks(s_keys), _chunks(s_payloads)):
        m = hist[k.long() - lo]
        at = m > 0
        kept.append(pack(k[at], p[at]))
        mults.append(m[at])
    del hist
    packed = torch.cat(kept)
    mult = torch.cat(mults)
    del kept, mults
    order = torch.sort(packed)
    packed, mult = order.values, mult[order.indices]
    del order
    if bool((mult > 1).any()):
        packed = torch.repeat_interleave(packed, mult.long())
    return packed
