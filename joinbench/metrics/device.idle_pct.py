"""device.idle_pct (%, lower is better; layer: the device, the H100): the
share of the traced window in which no operation ran on the device, from
the union of the intervals of its kernels, copies and sets
(torch.profiler).  Nothing without a traced device."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
