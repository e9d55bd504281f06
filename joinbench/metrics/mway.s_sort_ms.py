"""mway.s_sort_ms (ms, lower is better; layer: the join model,
``models/mway.py``): the device milliseconds a join of the span
``smj.mway.sort.s``, S's K1 block sort and its K2 merge levels on the
phased count route, between the span's CUDA events.  Nothing untraced, and
nothing from a program without the span."""

from joinbench.spans import device_ms_per_join


def read(run):
    return device_ms_per_join(run, "smj.mway.sort.s")
