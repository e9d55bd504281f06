"""mway.mergejoin_ms (ms, lower is better; layer: the kernels,
``csrc/merge_join_count.cu``): the device milliseconds a join of the span
``smj.phase.mergejoin``, the phased count route's K3 count of the two
sorted relations, between the span's CUDA events.  Nothing untraced."""

from joinbench.spans import device_ms_per_join


def read(run):
    return device_ms_per_join(run, "smj.phase.mergejoin")
