"""The m-pass count join on one device, as ``-a m-pass`` runs it:
``models.mpass.sortmergejoin_multipass(R, S, JoinConfig())``, the phased
route (K1 block sorts, the K4 pairwise merge passes, log2(blocks) a
relation, then the K3 count; no K2).  Answer: the count, read to the host
by the program; info: the program's phase times (``JoinResult.phases``,
seconds between CUDA events at the phase boundaries)."""

from avx_sort_merge_joins_tpu_torch.models.mpass import \
    sortmergejoin_multipass
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation

ANSWER = "count"


def prepare(rel, config, args):
    return (Relation(rel.r_keys, rel.r_payloads, rel.n_r),
            Relation(rel.s_keys, rel.s_payloads, rel.n_s), JoinConfig())


def join(state):
    r, s, cfg = state
    res = sortmergejoin_multipass(r, s, cfg)
    return {"count": res.totalresults}, {"phases": dict(res.phases)}
