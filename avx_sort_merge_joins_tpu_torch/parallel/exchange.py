"""Partition and exchange of relation shards over a mesh (counterpart of
``avx_sort_merge_joins_tpu/parallel/exchange.py:25-185``; reference: the
``threadrelchunks`` exchange matrix, src/joins/joincommon.h:129, written
at sortmergejoin_multiway.c:423-453 and read remotely at :504-518).

Each shard cuts its tuples into one padded bucket per destination shard;
the mesh's ``all_to_all`` delivers bucket d of every shard to shard d.
Buckets are padded to a static capacity (the analog of RELATION_PADDING,
src/params.h:41-72) with sentinel keys that never match across R and S:
R pads INT32_MAX, S pads INT32_MIN; live keys lie in [-2^31+2, 2^31-2].
A bucket that overflows its capacity is counted, never dropped silently.

Functions of one shard take its 1-D columns; the exchanges take the
mesh's per-shard values (``parallel/mesh.py``: a stacked ``(n, ...)``
tensor on a one-device mesh, a list of one tensor a shard otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

R_PAD_KEY = 2**31 - 1
S_PAD_KEY = -(2**31)


def valid_counts(n: int, shard: int, n_chips: int) -> np.ndarray:
    """Live tuples of each shard for an even leading-axis split: shard i
    owns rows [i*shard, (i+1)*shard) of the padded column, so its live
    prefix is clip(n - i*shard, 0, shard) -- zero for the tail shards of a
    tiny relation on a wide mesh."""
    return np.clip(n - shard * np.arange(n_chips, dtype=np.int64),
                   0, shard).astype(np.int32)


def bucket_cap(shard: int, n_chips: int, slack: float,
               align_elems: int) -> int:
    """Per-(shard, destination) bucket capacity: the average bucket times
    the slack factor, rounded up to ``align_elems``.  The JAX package's one
    formula, so capacities and the overflow retry match its own."""
    want = int(shard / n_chips * slack)
    return max(align_elems, -(-want // align_elems) * align_elems)


def dest_of_keys(keys: torch.Tensor, n_buckets: int, minkey,
                 maxkey) -> torch.Tensor:
    """Range-partition bucket of each key: floor((k - minkey) * B / span),
    with XLA's arithmetic: the offset and the span taken mod 2^32 (uint32,
    exact for any int32 keys), both converted to float32, and the offset
    multiplied by float32(B) / (span + 1), in that order, so that bucket
    boundaries equal the JAX package's.  ``minkey``/``maxkey`` are 0-d
    int32 tensors or ints."""
    mask = 0xFFFFFFFF
    lo = torch.as_tensor(minkey, dtype=torch.int64, device=keys.device)
    hi = torch.as_tensor(maxkey, dtype=torch.int64, device=keys.device)
    rel = (keys.to(torch.int64) - lo) & mask
    span = ((hi - lo) & mask).to(torch.float32) + 1.0
    scale = torch.tensor(float(n_buckets), dtype=torch.float32,
                         device=keys.device) / span
    d = torch.floor(rel.to(torch.float32) * scale).to(torch.int32)
    return torch.clamp(d, 0, n_buckets - 1)


def bucketize_by(dest: torch.Tensor, keys: torch.Tensor,
                 payloads: torch.Tensor, n_valid: int, n_buckets: int,
                 cap: int, pad_key: int):
    """Group one shard into ``n_buckets`` padded buckets of ``cap`` slots.

    ``keys``/``payloads`` are the shard's columns, live in ``[:n_valid]``;
    ``dest`` is each tuple's bucket.  A stable sort by destination keeps
    each bucket in the shard's order.  Returns ``(bkeys, bpayloads,
    counts, overflow)``: ``bkeys`` of ``n_buckets * cap`` slots with bucket
    d in ``[d*cap, d*cap + counts[d])`` and ``pad_key`` elsewhere
    (payload pads 0), ``counts`` int32, ``overflow`` the tuples that did
    not fit (an int32 0-d tensor)."""
    dev = keys.device
    n = keys.numel()
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    dest = torch.where(idx < n_valid, dest.to(torch.int64), n_buckets)
    dsort, order = torch.sort(dest, stable=True)
    counts_all = torch.bincount(dsort, minlength=n_buckets + 1)
    offsets = torch.cumsum(counts_all, 0) - counts_all
    within = idx - offsets[dsort]
    live = dsort < n_buckets
    fits = (within < cap) & live
    bk = torch.full((n_buckets * cap,), pad_key, dtype=keys.dtype, device=dev)
    bp = torch.zeros((n_buckets * cap,), dtype=payloads.dtype, device=dev)
    target = (dsort * cap + within)[fits]
    bk[target] = keys[order][fits]
    bp[target] = payloads[order][fits]
    overflow = ((within >= cap) & live).sum(dtype=torch.int32)
    counts = torch.clamp(counts_all[:n_buckets], max=cap).to(torch.int32)
    return bk, bp, counts, overflow


def exchange(mesh, bkeys, bpayloads, counts):
    """All-to-all the per-shard padded buckets: bucket d of shard s lands
    on shard d as received run s.  Returns the received ``(keys, payloads,
    counts)``; ``counts[d][s]`` is how many live tuples shard s sent shard
    d (its run at ``[s*cap, s*cap + counts[d][s])``)."""
    return (mesh.all_to_all(bkeys), mesh.all_to_all(bpayloads),
            mesh.all_to_all(counts))


def _swap_groups(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Rows of ``a x b`` groups (any leading dims) regrouped as ``b x a``:
    group (i, j) moves to (j, i)."""
    lead = x.shape[:-1]
    return x.reshape(*lead, a, b, -1).transpose(-3, -2).reshape(*lead, -1)


def exchange_hier(mesh, bflat, cap: int, host_schedule=None):
    """Two-stage all-to-all over a 2-D ``(host, chip)`` mesh: stage 1
    exchanges destination-chip groups within each host, so each shard
    gathers every co-hosted shard's traffic for its chip index; stage 2
    moves whole host groups across hosts, as one all-to-all or, with
    ``host_schedule`` (offsets over the hosts, from
    :func:`mesh.shuffle_order`), as collective-permute rounds.

    ``bflat`` is the per-shard ``(n*cap,)`` bucket layout, bucket d for
    flat shard d = h*C + c.  Returns the received per-shard value, bit for
    bit the flat exchange's: the run from source shard s at ``[s*cap,
    ...)``."""
    from .mesh import AXIS, HOST_AXIS

    H, C = mesh.hosts
    # stage 1: deliver destination-chip groups within the host
    x = mesh.map(lambda r: _swap_groups(r, H, C), bflat)   # [c_dest, h_dest]
    x = mesh.all_to_all(x, AXIS)                           # [c_src, h_dest]
    x = mesh.map(lambda r: _swap_groups(r, C, H), x)       # [h_dest, c_src]
    # stage 2: deliver host groups
    if host_schedule is None:
        return mesh.all_to_all(x, HOST_AXIS)               # [h_src, c_src]
    out = mesh.zeros_like(x)
    for off in host_schedule:
        off = int(off)
        piece = mesh.rotated_blocks(x, C * cap, off, group=C)
        if off != 0:
            piece = mesh.ppermute(piece, [(h, (h + off) % H)
                                          for h in range(H)], HOST_AXIS)
        mesh.put_rotated_blocks(out, piece, C * cap, -off, group=C)
    return out


def pad_column(x, total: int, fill: int, device=None) -> torch.Tensor:
    """A 1-D int32 column padded (or cut) to ``total`` slots with the
    sentinel ``fill``: the staging layout of every distributed path."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.int32))  # a writable copy
    out = torch.full((total,), fill, dtype=torch.int32,
                     device=device if device is not None else x.device)
    m = min(total, x.numel())
    out[:m] = x[:m]
    return out
