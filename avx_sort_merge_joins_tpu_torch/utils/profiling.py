"""Observability: the [RECORD] row, bytes-moved rooflines and profiler
traces (counterpart of ``avx_sort_merge_joins_tpu/utils/profiling.py``;
reference: src/util/rdtsc.h cycle timers printed by joincommon.c:175-196,
and the PCM wrapper src/util/perf_counters.c).

* :func:`record_line` -- one grid row in the reference scripts' columns;
* :class:`BytesMoved` -- per-phase read + write bytes turned into
  ``[ROOFLINE]`` rows against a copy rate;
* :func:`measure_copy_bandwidth` / :func:`hbm_gbps` -- that copy rate,
  measured on the device the join ran on (``SMJ_HBM_GBPS`` overrides it);
  never a constant taken from another device;
* :func:`trace` -- a ``torch.profiler`` context writing a Chrome trace
  (the PCM_start/stop analog, perf_counters.h:51-103);
* :func:`span`, :func:`count`, :func:`sync` -- the program's spans
  (``smj.<layer>.<what>``) and counters, and :func:`span_totals` /
  :func:`reset` over their registry.

Spans and counters are on only while a ``torch.profiler`` session records
(``-o DIR``, or a benchmark's traced run); off, a span is one check and a
shared no-op context.  On, a span is a host event on the profiler's clock
(a ``RecordFunction`` of function scope: unlike ``record_function``'s user
scope it casts no GPU-side annotation among the device's operations), its
host seconds, and once CUDA is initialised in the process a pair of CUDA
events on the current stream, read only by :func:`span_totals`: nothing
is synchronised when a span is recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict

import torch

# canonical phase order of the reference's record format
# (scripts/tput-scalability.sh:28: PARTCYC SORTCYC MERGE1CYC MERGERESTCYC
# MJOINCYC NUMTUP USECS TPUT) -- microseconds stand where the reference
# reports cycles, so grid outputs diff row for row.
RECORD_PHASES = ("part", "sort", "merge1", "mergerest", "mergejoin")


def record_line(algo: str, nthreads: int, n_r: int, n_s: int, run_no: int,
                phases: Dict[str, float], device: str) -> str:
    """One grid-record row in the reference scripts' column layout, with
    one more column at the end: the device it ran on (spaces as ``_``), so
    that a CPU row never passes for a card's."""
    ntuples = n_r + n_s
    total = phases.get("total", sum(
        v for k, v in phases.items() if k != "total"))

    def us(k):
        return phases.get(k, 0.0) * 1e6

    cols = " ".join(f"{us(k):.0f}" for k in RECORD_PHASES)
    tput = ntuples / total if total > 0 else 0.0
    return (f"[RECORD] {algo} {nthreads} {n_r} {n_s} {run_no} {cols} "
            f"{ntuples} {total * 1e6:.0f} {tput:.0f} "
            f"{device.replace(' ', '_')}")


@dataclasses.dataclass
class BytesMoved:
    """Per-phase device-memory traffic for roofline reports, the analog of
    the reference's speed-of-light comparisons against memcpy
    (multiwaymergebench.c:178-221)."""

    phases: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, phase: str, nbytes: int) -> None:
        self.phases[phase] = self.phases.get(phase, 0) + nbytes

    @staticmethod
    def sort_bytes(n: int, passes: int, keys_only: bool = False) -> int:
        """Read + write bytes of a block sort and ``passes`` merge passes
        over n tuples."""
        width = 4 if keys_only else 8
        return (passes + 1) * n * width * 2

    def roofline_report(self, timings: Dict[str, float],
                        bandwidth_gbps: float) -> str:
        """One ``[ROOFLINE]`` row a phase that has bytes and a time: its
        GB/s and its share of ``bandwidth_gbps``."""
        lines = []
        for phase, nbytes in self.phases.items():
            secs = timings.get(phase)
            if not secs:
                continue
            gbps = nbytes / secs / 1e9
            lines.append(f"[ROOFLINE] {phase:14s} {gbps:8.1f} GB/s "
                         f"({100 * gbps / bandwidth_gbps:5.1f}% of "
                         f"{bandwidth_gbps:.0f} GB/s)")
        return "\n".join(lines)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_copy_bandwidth(nbytes: int = 1 << 30, reps: int = 3,
                           device="cuda") -> float:
    """Achievable read + write rate of ``device``'s memory in GB/s: ten
    chained ``+ 1`` passes over an ``nbytes`` int32 column, the best of
    ``reps`` timed chains after one warm-up, synchronised on the card (the
    memcpy speed-of-light baseline, partition.c:387-436)."""
    device = torch.device(device)
    x = torch.zeros(nbytes // 4, dtype=torch.int32, device=device)

    def chain(a):
        for _ in range(10):
            a = a + 1
        return a

    chain(x)
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        chain(x)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return 10 * 2 * (nbytes // 4 * 4) / best / 1e9


_MEASURED: Dict[str, float] = {}


def hbm_gbps(device) -> tuple[float, str]:
    """The denominator of the ``[ROOFLINE]`` rows and where it came from:
    ``SMJ_HBM_GBPS`` when it is set, else :func:`measure_copy_bandwidth`
    on ``device``, measured once a process and device."""
    env = os.environ.get("SMJ_HBM_GBPS")
    if env:
        return float(env), "SMJ_HBM_GBPS"
    device = torch.device(device)
    key = str(device)
    if key not in _MEASURED:
        # a smaller column on the CPU: its copy rate saturates far sooner
        nbytes = 1 << 30 if device.type == "cuda" else 1 << 26
        _MEASURED[key] = measure_copy_bandwidth(nbytes, device=device)
    return _MEASURED[key], f"copy rate measured on {key}"


# -- spans and counters ------------------------------------------------

HOST_SYNCS = "smj.host_syncs"  # the counter sync() adds to
_OFF = contextlib.nullcontext()
# name -> [calls, host seconds, device seconds resolved, pending event
# pairs]; counter name -> count
_SPANS: Dict[str, list] = {}
_COUNTS: Dict[str, int] = {}


def recording() -> bool:
    """Whether a ``torch.profiler`` session records in this process: the
    gate of every span and counter."""
    return torch._C._autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "rf", "t0", "ev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.ev = None
        if torch.cuda.is_initialized():
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        entry = _SPANS.setdefault(self.name, [0, 0.0, 0.0, []])
        entry[0] += 1
        entry[1] += host
        if self.ev is None:
            entry[2] += host  # no device: the work ran as it was issued
        else:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            entry[3].append((self.ev, end))
        self.rf.__exit__(*exc)


def span(name: str):
    """A context that records the block as the span ``name`` while a
    profiler session records, and does nothing otherwise."""
    return _Span(name) if recording() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session
    records."""
    if recording():
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def sync(what: str, n: int = 1):
    """The context of a blocking read of the device by the host (or of a
    wait for it): counts ``n`` host syncs under :data:`HOST_SYNCS` and
    records the block as the span ``smj.sync.<what>``, while a profiler
    session records.  A read of a tensor's value counts on any device; a
    wait for a device counts only where there is one to wait for."""
    if not recording():
        return _OFF
    _COUNTS[HOST_SYNCS] = _COUNTS.get(HOST_SYNCS, 0) + n
    return _Span("smj.sync." + what)


@dataclasses.dataclass
class SpanTotal:
    """A span's calls and summed host and device seconds; a counter's
    count as ``calls``, with no seconds."""

    calls: int
    host_s: float
    device_s: float


def span_totals() -> Dict[str, SpanTotal]:
    """Every span and counter recorded since :func:`reset`, by name.  A
    span's device seconds lie between its CUDA events; without them (no
    CUDA in the process) they are its host seconds.  It waits for each
    span's end event, so call it after the recorded work."""
    for entry in _SPANS.values():
        for a, b in entry[3]:
            b.synchronize()
            entry[2] += a.elapsed_time(b) / 1e3
        entry[3].clear()
    out = {name: SpanTotal(calls, host, dev)
           for name, (calls, host, dev, _) in _SPANS.items()}
    out.update((name, SpanTotal(n, 0.0, 0.0)) for name, n in _COUNTS.items())
    return out


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _SPANS.clear()
    _COUNTS.clear()


TRACE_FILE = "trace.json"  # what trace() writes into its logdir


@contextlib.contextmanager
def trace(logdir: str, device="cpu"):
    """A ``torch.profiler`` trace of the block: CPU activity, and CUDA
    activity when ``device`` is the card.  On exit it writes
    ``logdir/TRACE_FILE`` (a Chrome trace: chrome://tracing or Perfetto)
    and yields nothing.  The program's spans (:func:`span`) are in it,
    and the registry of :func:`span_totals` starts empty with it."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=acts) as prof:
        try:
            yield
        finally:
            _sync(device)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))

