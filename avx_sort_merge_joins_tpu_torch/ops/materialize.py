"""Join-output materialization (counterpart of
``avx_sort_merge_joins_tpu/ops/materialize.py:32-88``).

The reference's merge_join materializes the matching S tuple ``<S-key,
S-RID>`` per match pair (src/joins/joincommon.c:272-284 under
JOIN_MATERIALIZE): every S tuple is emitted once per matching R tuple, in
S order per key.

The JAX functions compute this outside any Pallas kernel, so plain torch
ops are the port: per S tuple, cntR(key) as a ``torch.searchsorted`` rank
difference over the sorted R keys; the matched S tuples by a gather at the
mask's indices, which keeps their order; the replication of duplicate R keys by
``torch.repeat_interleave``.  TPU workarounds dropped: the stable 5-operand
sort by (tag, index) that compacts without a scatter, the static output
capacity ``cap_out`` of ``expand_matches`` with its ``searchsorted`` gather,
and the unmatched rows kept past ``n_matched`` -- the port's outputs hold
the live rows only.
"""

from __future__ import annotations

import torch

from ..types import Relation
from ..utils import profiling


def materialize_matches(rk_sorted: torch.Tensor, nR: int,
                        sk_sorted: torch.Tensor, sp_sorted: torch.Tensor,
                        nS: int):
    """Emit matched S tuples (the reference's <S-key, S-RID> convention).

    Inputs are sorted columns (R keys; S keys + payloads).  Returns
    ``(out_keys, out_payloads, out_mult, n_matched)``: the ``n_matched``
    matched S tuples in S order, with ``out_mult[i]`` = cntR(key_i) in
    int32 (1 for a primary-key R).  Total matches =
    ``out_mult.sum(dtype=torch.int64)``.  The span ``smj.ops.materialize``.
    """
    with profiling.span("smj.ops.materialize"):
        rk = rk_sorted[:nR]
        sk = sk_sorted[:nS]
        sp = sp_sorted[:nS]
        lo = torch.searchsorted(rk, sk, out_int32=True)
        hi = torch.searchsorted(rk, sk, right=True, out_int32=True)
        mult = hi - lo
        with profiling.sync("nonzero"):  # sizes its output on the host
            at = torch.nonzero(mult > 0).squeeze(1)  # ascending: S order
        return sk[at], sp[at], mult[at], int(at.numel())


def expand_matches(ok: torch.Tensor, op: torch.Tensor, om: torch.Tensor,
                   n_matched: int):
    """Replicate matched S tuples by their R multiplicity -- one output
    tuple per match pair, the reference's nested duplicate loops
    (src/joins/joincommon.c:266-289).  Returns ``(ekeys, epayloads,
    total)`` with ``total`` rows.  The span ``smj.ops.materialize``."""
    with profiling.span("smj.ops.materialize"):
        mult = om[:n_matched].to(torch.int64)
        # each call sums ``mult`` on the host to size its output
        with profiling.sync("repeat_interleave", 2):
            ek = torch.repeat_interleave(ok[:n_matched], mult)
            ep = torch.repeat_interleave(op[:n_matched], mult)
        return ek, ep, int(ek.numel())


def materialized_relation(ok: torch.Tensor, op: torch.Tensor,
                          n_matched: int) -> Relation:
    """Wrap compacted match columns as a Relation of n_matched tuples."""
    return Relation(ok, op, int(n_matched), sorted=True)
