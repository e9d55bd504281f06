"""The MPSM count join on one device, as ``-a mpsm --nchunks T`` runs it:
``models.mpsm.sortmergejoin_mpsm(R, S, JoinConfig(), nchunks=T)``, the
phased route (R sorted once by K1 + K2, S cut into T private runs each
sorted on its own, then one K3 count of all of R against each run, summed
on the device).  T is the configuration's ``s_runs``.  Answer: the count,
read to the host by the program; info: the program's phase times
(``JoinResult.phases``, seconds between CUDA events at the phase
boundaries)."""

from avx_sort_merge_joins_tpu_torch.models.mpsm import sortmergejoin_mpsm
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation

ANSWER = "count"


def prepare(rel, config, args):
    return (Relation(rel.r_keys, rel.r_payloads, rel.n_r),
            Relation(rel.s_keys, rel.s_payloads, rel.n_s), JoinConfig(),
            int(config["s_runs"]))


def join(state):
    r, s, cfg, runs = state
    res = sortmergejoin_mpsm(r, s, cfg, nchunks=runs)
    return {"count": res.totalresults}, {"phases": dict(res.phases)}
