"""device.idle_in_program_pct (%, lower is better; layer: the device, the
H100): the share of the traced window in which no operation ran on the
device while the host was inside the program's ``smj.join`` span, from
the union of the device's intervals (``run.trace.ops``) against the
span's host intervals (``run.trace.host``), on the profiler's one clock.
At most ``device.idle_pct``: the rest of the idle time is the harness's
(its calls, the answer's read).  Nothing without a traced device or the
span."""

from joinbench.trace import _merged

SPAN = "smj.join"


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    joins = _merged([(s, s + d) for name, s, d in tr.host if name == SPAN],
                    *tr.window)
    if not joins:
        return None
    busy = _merged([(s, s + d) for _, s, d in tr.ops], *tr.window)
    idle, i = 0, 0
    for s, e in joins:
        idle += e - s
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            idle -= min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return 100.0 * idle / (tr.window[1] - tr.window[0])
