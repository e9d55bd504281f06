"""Shared helpers of the micro-benchmarks (counterpart of
``avx_sort_merge_joins_tpu/bench/common.py``)."""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

NO_DEVICE_EXIT = 1


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default; exit 1 without one), or the CPU "
                        "through the kernels' plain PyTorch versions")


def pick_device(name: str) -> torch.device | None:
    """The device named by ``--device``; None, with a message, when it is
    the card and there is none (no silent CPU)."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("[ERROR] no CUDA device (torch.cuda.is_available() is false); "
              "pass --device cpu for the plain PyTorch versions",
              file=sys.stderr)
        return None
    return torch.device("cuda")


def _on_cuda(x) -> bool:
    if isinstance(x, (tuple, list)):
        return any(_on_cuda(v) for v in x)
    return isinstance(x, torch.Tensor) and x.is_cuda


def time_steady(fn, *args, reps: int = 3, burn: int = 2) -> float:
    """Steady-state seconds per call of ``fn(*args)``: one warm-up call,
    ``burn`` untimed calls, then the mean of ``reps`` timed calls.  On the
    card the timed calls are queued between two CUDA events and the time
    is the device's, read after one synchronise; on the CPU it is the host
    clock."""
    cuda = _on_cuda(fn(*args)) or _on_cuda(args)
    for _ in range(burn):
        fn(*args)
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def check_sorted(keys: np.ndarray) -> bool:
    return bool(np.all(keys[1:] >= keys[:-1]))


def gen_keys(n: int, seed: int = 12345) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**30), 2**30, n).astype(np.int32)
