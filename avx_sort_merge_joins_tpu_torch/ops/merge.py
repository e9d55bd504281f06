"""2-way merge facade (counterpart of
``avx_sort_merge_joins_tpu/ops/merge.py:21-55``; reference:
src/merge/merge.c, avx_merge_tuples / scalar_merge_tuples).

``merge_tuples`` lays the two runs out as a two-run uniform-lens column
(``sort.two_run_layout``) and merges it with ``multiway_merge`` at fan-in
2: kernel K6 for (key, payload) pairs, K2 for keys only.  The JAX facade
passes the run lengths as a static list and rounds its stride to whole
tiles; the port's padded two-run layout needs neither.
"""

from __future__ import annotations

import numpy as np
import torch

from . import multiwaymerge as mw
from . import sort as sort_ops


def merge_tuples(ka: torch.Tensor, pa: torch.Tensor | None,
                 kb: torch.Tensor, pb: torch.Tensor | None,
                 na: int | None = None, nb: int | None = None):
    """Merge two ascending (keys, payloads) columns into one, in
    lexicographic order -- avx_merge_tuples (merge.h:38-50).  ``pa`` and
    ``pb`` None merges keys only and returns ``(keys, None)``."""
    na = int(ka.numel()) if na is None else na
    nb = int(kb.numel()) if nb is None else nb
    keys, payloads, lens = sort_ops.two_run_layout(ka, kb, na, nb, pa, pb)
    merged, _ = mw.multiway_merge(keys, 2, lens, payloads)
    n = na + nb
    if payloads is None:
        return merged[:n], None
    return merged[0][:n], merged[1][:n]


def scalar_merge_tuples(ka: torch.Tensor, pa: torch.Tensor,
                        kb: torch.Tensor, pb: torch.Tensor,
                        na: int | None = None, nb: int | None = None):
    """``torch.sort`` baseline merge -- scalar_merge_tuples
    (merge.h:66-78)."""
    na = int(ka.numel()) if na is None else na
    nb = int(kb.numel()) if nb is None else nb
    return sort_ops.sort_torch(torch.cat([ka[:na], kb[:nb]]),
                               torch.cat([pa[:na], pb[:nb]]))


def merge_numpy(ka, pa, kb, pb):
    """NumPy oracle (the qsort-validated expectation of check_merge.c)."""
    k = np.concatenate([ka, kb])
    p = np.concatenate([pa, pb])
    order = np.lexsort((p, k))
    return k[order], p[order]
