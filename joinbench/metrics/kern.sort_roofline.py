"""kern.sort_roofline (%, higher is better; layer: the kernels): the
block sorts' share of their roofline.  The least time they could take,
the bytes below over the H100's published 3.35 TB/s, divided by the
summed device time (torch.profiler) of the kernels whose names match
``PATTERN`` over the traced window: K1 ``block_sort_kernel``
(``csrc/block_sort.cu``) and K5 ``block_sort_pairs_kernel``
(``csrc/block_sort_pairs.cu``).

Bytes come from the cell's sizes and tuple width alone: each relation
read once and written once by its sort, 2 * key_bytes a keys-only tuple
and 4 * key_bytes a (key, payload) pair, whatever the implementation
reads again.  Nothing when no such kernel ran."""

from joinbench.peaks import HBM_BYTES_PER_S

PATTERN = r"\bblock_sort(_pairs)?_kernel\b"


def bytes_per_join(n_r: int, n_s: int, s_pairs: bool,
                   key_bytes: int = 4) -> int:
    return 2 * key_bytes * n_r + (4 if s_pairs else 2) * key_bytes * n_s


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(PATTERN)
    if seconds <= 0:
        return None
    need = bytes_per_join(run.n_r, run.n_s, run.s_pairs,
                          run.key_bytes) * run.n_joins
    return 100.0 * need / HBM_BYTES_PER_S / seconds
