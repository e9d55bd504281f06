"""kern.merge_roofline (%, higher is better; layer: the kernels): the
merges' share of their roofline.  The least time the merge of block runs
into one sorted run could take, the bytes below over the H100's
published 3.35 TB/s, divided by the summed device time (torch.profiler)
of the kernels whose names match ``PATTERN`` over the traced window: K2
and K6 ``corank_kernel`` and ``merge_kernel`` (``csrc/multiway_merge.cu``,
uniform and varlen) and the K9 ``gate_kernel``
(``csrc/chunk_gated_merge.cu``), whichever levels and exchanges the
route runs.

Bytes come from the cell's sizes alone: each relation read once and
written once, 8 B a keys-only tuple and 16 B a (key, payload) pair,
whatever the implementation reads again; a route that merges in fewer
passes shows as a gain.  Nothing when no such kernel ran."""

from joinbench.peaks import HBM_BYTES_PER_S

PATTERN = r"\b(corank_kernel|merge_kernel|gate_kernel)\b"


def bytes_per_join(n_r: int, n_s: int, s_pairs: bool) -> int:
    return 8 * n_r + (16 if s_pairs else 8) * n_s


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(PATTERN)
    if seconds <= 0:
        return None
    need = bytes_per_join(run.n_r, run.n_s, run.s_pairs) * run.n_joins
    return 100.0 * need / HBM_BYTES_PER_S / seconds
