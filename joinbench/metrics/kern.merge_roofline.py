"""kern.merge_roofline (%, higher is better; layer: the kernels): the
merges' share of their roofline.  The least time the merge of block runs
into one sorted run could take, the bytes below over the H100's
published 3.35 TB/s, divided by the summed device time (torch.profiler)
of the kernels whose names match ``PATTERN`` over the traced window: K2
and K6 ``corank_kernel`` and ``merge_kernel`` (``csrc/multiway_merge.cu``,
uniform and varlen), the K9 ``gate_kernel`` (``csrc/chunk_gated_merge.cu``)
and the K4 ``merge_pass_kernel`` (``csrc/merge_pass.cu``, m-pass's
pairwise passes), whichever levels, passes and exchanges the route runs.

Bytes come from the cell's sizes and tuple width alone: each relation
read once and written once, 2 * key_bytes a keys-only tuple and 4 *
key_bytes a (key, payload) pair, whatever the implementation reads
again; a route that merges in fewer passes shows as a gain, and m-pass's
log2(blocks) passes as a low share.  Nothing when no such kernel ran."""

from joinbench.peaks import HBM_BYTES_PER_S

PATTERN = r"\b(corank_kernel|merge_kernel|gate_kernel|merge_pass_kernel)\b"


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
