"""dist.splitter_ms (ms, lower is better; layer: the distributed join,
``parallel/dist_mway.py``): the device milliseconds a join of the span
``smj.dist.splitters`` (``_equidepth_bounds``: the quantile samples of
every shard, their all-gather and the splitters), between the span's CUDA
events.  Nothing untraced."""

from joinbench.spans import device_ms_per_join


def read(run):
    return device_ms_per_join(run, "smj.dist.splitters")
