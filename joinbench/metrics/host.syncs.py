"""host.syncs (syncs/join, lower is better; layer: the host, the port's
Python between launches and its blocking reads): the program's counter
``smj.host_syncs`` over the window's joins.  It counts every blocking read
of the device by the host and every wait for a card that the program
makes (``utils/profiling.sync``: ``common.device_sync``, ``Mesh.tolist``,
``Mesh.host_sum``, ``finish_count_fused``, materialize's ``nonzero``,
match sum and ``repeat_interleave``), each in a span ``smj.sync.<what>``.
Nothing untraced."""

from joinbench.spans import calls_per_join


def read(run):
    return calls_per_join(run, "smj.host_syncs")
