"""The distributed m-way count join of the workload-A scale tier:
``parallel.scale.join_sharded(rk, sk, |R|, |S|, make_mesh(shards),
slack=...)``, the fused route (``dist_mway.dist_mway_join_count``: local
sorts, splitters, buckets, the exchange, the varlen K2 merges of the
received runs, K3 a shard).  The relations are the configuration's
shards of one device, each relation cut into ``shards`` equal rows.
Answer: the count and the bucket overflow (host ints); info: the slack
the join was given and the one it ended at (``dist_mway.LAST_SLACK``,
doubled once a retry)."""

from avx_sort_merge_joins_tpu_torch.parallel import dist_mway, scale
from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

ANSWER = "count"


def prepare(rel, config, args):
    n = int(config["shards"])
    return (rel.r_keys.view(n, -1), rel.s_keys.view(n, -1), rel.n_r,
            rel.n_s, make_mesh(n, device=rel.device), float(args["slack"]))


def join(state):
    rk, sk, n_r, n_s, mesh, slack = state
    count, overflow = scale.join_sharded(rk, sk, n_r, n_s, mesh, slack=slack)
    return ({"count": count, "overflow": overflow},
            {"slack_start": slack, "slack_end": dist_mway.LAST_SLACK})
