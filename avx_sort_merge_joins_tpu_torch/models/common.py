"""Shared join runner (counterpart of
``avx_sort_merge_joins_tpu/models/common.py``; reference:
src/joins/joincommon.c): phase orchestration, timing and result assembly."""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from ..types import JoinResult
from ..utils import profiling


def _sync_devices(devices) -> None:
    if devices:
        with profiling.sync("device", len(devices)):
            for d in devices:
                torch.cuda.synchronize(d)


def device_sync(x) -> None:
    """Wait for the card when ``x`` (a tensor or a tuple of them) is on one:
    PyTorch returns before the device has finished.  One wait a card."""
    leaves = x if isinstance(x, (tuple, list)) else (x,)
    _sync_devices({leaf.device for leaf in leaves
                   if isinstance(leaf, torch.Tensor) and leaf.is_cuda})


def run_phases(phases: Dict[str, Callable], device=None):
    """Run named phase thunks, each in the span ``smj.phase.<name>`` (the
    analog of the per-phase cycle stats printed by joincommon.c:175-196).
    Each thunk receives the previous thunk's result.

    On a CUDA ``device`` each phase is timed between CUDA events recorded
    on the device's current stream at the phase boundaries, with one sync
    at the end and none between phases; elsewhere each phase is timed on
    the host clock after a device sync.  ``"total"`` is the host wall
    time.  Seconds."""
    timings = {}
    result = None
    t_total = time.perf_counter()
    if device is not None and torch.device(device).type == "cuda":
        stream = torch.cuda.current_stream(device)
        marks = [stream.record_event(torch.cuda.Event(enable_timing=True))]
        for name, fn in phases.items():
            with profiling.span("smj.phase." + name):
                result = fn(result)
            marks.append(stream.record_event(
                torch.cuda.Event(enable_timing=True)))
        _sync_devices({torch.device(device)})
        for name, a, b in zip(phases, marks, marks[1:]):
            timings[name] = a.elapsed_time(b) / 1e3
    else:
        for name, fn in phases.items():
            t0 = time.perf_counter()
            with profiling.span("smj.phase." + name):
                result = fn(result)
                device_sync(result)
            timings[name] = time.perf_counter() - t0
    timings["total"] = time.perf_counter() - t_total
    return result, timings


def make_result(matches: int, nR: int, nS: int,
                timings: Dict[str, float]) -> JoinResult:
    total = timings["total"]
    tput = (nR + nS) / total if total > 0 else 0.0
    return JoinResult(
        totalresults=int(matches),
        resultlist=[],
        phases=timings,
        throughput=tput,
    )
