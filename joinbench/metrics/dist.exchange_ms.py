"""dist.exchange_ms (ms, lower is better; layer: the distributed join,
``parallel/dist_mway.py``, ``exchange.py``, ``mesh.py``): the device
milliseconds a join of the spans ``smj.dist.cut`` (``_cut_all``: the bucket
starts, their read, the slice copies and fills) and ``smj.dist.exchange``
(the counts' all-to-all and each landing's ``all_to_all_row``, or the
scheduled, overlapped or pushed exchange), between the spans' CUDA
events.  Nothing untraced."""

from joinbench.spans import device_ms_per_join


def read(run):
    return device_ms_per_join(run, "smj.dist.cut", "smj.dist.exchange")
