"""dist.retries (retries/join, lower is better; layer: the distributed
join, ``parallel/dist_mway.py``, ``exchange.py``, ``mesh.py``,
``scale.py``): the mean over the window's joins of the slack doublings a
join made after a bucket overflow, log2 of ``dist_mway.LAST_SLACK`` over
the slack the join was given.  Only the distributed entries report it."""

import math


def read(run):
    vals = [math.log2(j["slack_end"] / j["slack_start"]) for j in run.joins
            if j.get("slack_end") is not None]
    return sum(vals) / len(vals) if vals else None
