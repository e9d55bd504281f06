"""ops.materialize_ms (ms, lower is better; layer: the operators,
``ops/materialize.py``): the device milliseconds a join of the span
``smj.ops.materialize`` (``materialize_matches``: the two
``torch.searchsorted`` over the sorted R keys, the mask, ``nonzero`` and
the gathers; and ``expand_matches`` where an R key repeats), between the
span's CUDA events.  Nothing untraced."""

from joinbench.spans import device_ms_per_join


def read(run):
    return device_ms_per_join(run, "smj.ops.materialize")
