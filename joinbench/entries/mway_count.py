"""The m-way count join on one device, as ``-a m-way`` runs it:
``models.mway.sortmergejoin_multiway(R, S, JoinConfig())``, the phased
route (K1 block sorts, the K2 merge levels, the K3 count).  Answer: the
count, read to the host by the program; info: the program's phase times
(``JoinResult.phases``, seconds on the host clock after a device sync)."""

from avx_sort_merge_joins_tpu_torch.models.mway import sortmergejoin_multiway
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation

ANSWER = "count"


def prepare(rel, config, args):
    return (Relation(rel.r_keys, rel.r_payloads, rel.n_r),
            Relation(rel.s_keys, rel.s_payloads, rel.n_s), JoinConfig())


def join(state):
    r, s, cfg = state
    res = sortmergejoin_multiway(r, s, cfg)
    return {"count": res.totalresults}, {"phases": dict(res.phases)}
