"""The materializing m-way join on one device, as ``-a m-way
--materialize`` runs it: ``models.mway.sortmergejoin_multiway(R, S,
JoinConfig(materialize=True))`` (R's keys through K1 + K2, S's pairs
through K5 + K6, the matched rows by ``ops/materialize.py``).  Answer: the
count and the rows ``<S-key, S-RID>`` of ``resultlist[0].results``, left
on the device; info: the program's phase times."""

from avx_sort_merge_joins_tpu_torch.models.mway import sortmergejoin_multiway
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation

ANSWER = "rows"


def prepare(rel, config, args):
    return (Relation(rel.r_keys, rel.r_payloads, rel.n_r),
            Relation(rel.s_keys, rel.s_payloads, rel.n_s),
            JoinConfig(materialize=True))


def join(state):
    r, s, cfg = state
    res = sortmergejoin_multiway(r, s, cfg)
    out = res.resultlist[0].results
    n = out.num_tuples
    return ({"count": res.totalresults,
             "rows": (out.keys[:n], out.payloads[:n])},
            {"phases": dict(res.phases)})
