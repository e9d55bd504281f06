"""mpsm.mergejoin_ms (ms, lower is better; layer: the kernels,
``csrc/merge_join_count.cu``): the device milliseconds a join of the span
``smj.phase.mergejoin`` on the MPSM route, the K3 counts of all of R
against each private S run and their sum on the device, between the
span's CUDA events.  Nothing untraced."""

from joinbench.spans import device_ms_per_join


def read(run):
    return device_ms_per_join(run, "smj.phase.mergejoin")
