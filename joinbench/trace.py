"""The reduction of a ``torch.profiler`` trace of the window to what the
per-layer readers and the result's ``breakdown`` read: the device's
operations (kernels, copies, sets) with their intervals, the traced
window, the union of busy time inside it, and the host's spans.

The harness marks the window and each join with spans of its own
(``record_function``): ``joinbench.window``, ``joinbench.join`` (the
call into the program) and ``joinbench.result_read`` (the answer read to
the host).  An idle gap on the device is labelled by the harness span
and the innermost host operation that cover its midpoint.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

WINDOW = "joinbench.window"
SPANS = ("joinbench.join", "joinbench.result_read")
TOP = 10


@dataclasses.dataclass
class Trace:
    """Intervals in ns on the profiler's clock."""

    window: tuple[int, int]
    ops: list  # (name, start, duration) of each device operation
    host: list  # (name, start, duration) of each host operation
    busy_ns: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device time of the operations whose name matches
        ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        return sum(d for name, _, d in self.ops if rx.search(name)) / 1e9


def _is_device(ev) -> bool:
    kind = str(ev.device_type())
    if not kind.endswith("CUDA"):
        return False
    act = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") \
        else ""
    return "annotation" not in act and not ev.name().startswith("joinbench.")


def _merged(intervals: list, lo: int, hi: int) -> list:
    """The union of ``(start, end)`` intervals clipped to [lo, hi], as
    disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof) -> Trace | None:
    """The trace of a finished ``torch.profiler.profile``; None where the
    window's span is missing."""
    events = prof.profiler.kineto_results.events()
    window, ops, host = None, [], []
    for ev in events:
        name, start, dur = ev.name(), ev.start_ns(), ev.duration_ns()
        if _is_device(ev):
            ops.append((name, start, dur))
        elif name == WINDOW:
            window = (start, start + dur)
        elif str(ev.device_type()).endswith("CPU"):
            host.append((name, start, dur))
    if window is None:
        return None
    ops = [op for op in ops if op[1] < window[1] and op[1] + op[2] > window[0]]
    busy = _merged([(s, s + d) for _, s, d in ops], *window)
    return Trace(window, ops, host, int(sum(e - s for s, e in busy)))


def _short(name: str) -> str:
    """A kernel's name without its namespaces' "(anonymous namespace)",
    its argument list and its return type."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name[5:] if name.startswith("void ") else name


def device_ops(tr: Trace) -> list:
    """The ``TOP`` device operations by summed time: ``[name, seconds]``."""
    by = {}
    for name, _, d in tr.ops:
        key = _short(name)
        by[key] = by.get(key, 0) + d
    top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k, v / 1e9] for k, v in top]


def idle_gaps(tr: Trace) -> list:
    """The ``TOP`` longest idle gaps inside the window: ``[label,
    seconds]``, the label ``<harness span>/<innermost host operation>`` at
    the gap's midpoint."""
    busy = _merged([(s, s + d) for _, s, d in tr.ops], *tr.window)
    edges = [tr.window[0]] + [x for iv in busy for x in iv] + [tr.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    if not gaps:
        return []
    names = [h[0] for h in tr.host]
    starts = np.array([h[1] for h in tr.host], dtype=np.int64)
    ends = starts + np.array([h[2] for h in tr.host], dtype=np.int64)
    spans = np.array([n in SPANS for n in names])
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        cover = (starts <= mid) & (ends >= mid)
        span = "harness"
        if (cover & spans).any():
            span = names[int(np.flatnonzero(cover & spans)[0])].split(".")[1]
        inner = np.flatnonzero(cover & ~spans)
        op = "python"
        if inner.size:
            op = names[int(inner[np.argmin(ends[inner] - starts[inner])])]
        out.append([f"{span}/{op}", (e - s) / 1e9])
    return out
