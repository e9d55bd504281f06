"""mpsm.s_sort_ms (ms, lower is better; layer: the join model,
``models/mpsm.py``): the device milliseconds a join of the span
``smj.mpsm.sort.s``, the sorts of all the private S runs (K1 and the K2
levels of each run), between the span's CUDA events.  Nothing untraced,
and nothing from a program without the span."""

from joinbench.spans import device_ms_per_join


def read(run):
    return device_ms_per_join(run, "smj.mpsm.sort.s")
