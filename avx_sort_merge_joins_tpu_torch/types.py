"""Core data types of the PyTorch/CUDA port (counterpart of
``avx_sort_merge_joins_tpu/types.py:30-141``).

Relations stay columnar: separate int32 ``keys`` and ``payloads`` tensors
on an explicit device.  Columns are flat 1-D tensors whose logical length
is ``num_tuples``; trailing slots, if any, hold the +inf sentinel
INT32_MAX (keys) and 0 (payloads).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

# int32 max sorts after every real key (keys lie in [-2^31+2, 2^31-2])
from .ops.bitonic import KEY_POS_INF as KEY_SENTINEL


# The caching allocator's setting the entry points (the CLI, the results
# grid, rerun_cells and the script twins) install unless the caller set
# PYTORCH_CUDA_ALLOC_CONF: expandable segments, with which the scalesize
# row of 60 x 32 Mi keys a side fits the 80 GB card (the default leaves
# blocks it holds but cannot reuse), at no cost on the grid's cells.
ALLOC_CONF_DEFAULT = "expandable_segments:True"


def default_alloc_conf() -> None:
    """Install :data:`ALLOC_CONF_DEFAULT` unless ``PYTORCH_CUDA_ALLOC_CONF``
    is set.  It takes effect only before the process's first CUDA call."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF_DEFAULT)


def default_device() -> torch.device:
    """The card.  Raises when there is none: the CPU, where every kernel
    wrapper takes its plain PyTorch version, is used only when a caller
    names it (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); pass device='cpu' (CLI: --device cpu) "
                           "to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def device_name(device: torch.device) -> str:
    """What a measurement ran on: the card's name, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


@dataclasses.dataclass
class Relation:
    """A columnar relation of <int32 key, int32 payload> tuples.

    ``num_tuples`` is the logical size; ``keys``/``payloads`` may carry
    trailing padding (the reference's RELATION_PADDING discipline,
    src/params.h:41-72).
    """

    keys: torch.Tensor
    payloads: torch.Tensor
    num_tuples: int
    sorted: bool = False

    @property
    def capacity(self) -> int:
        return int(self.keys.shape[-1])

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        n = self.num_tuples
        return (self.keys[:n].cpu().numpy(), self.payloads[:n].cpu().numpy())

    @classmethod
    def from_numpy(
        cls,
        keys: np.ndarray,
        payloads: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        device: Optional[torch.device | str] = None,
        sorted: bool = False,
    ) -> "Relation":
        """Build a relation from host columns, e.g. the JAX package's
        ``Relation.to_numpy()`` arrays, on ``device`` (default: the card,
        see :func:`default_device`; the CPU only when named)."""
        keys = np.asarray(keys, dtype=np.int32)
        n = keys.shape[-1]
        if payloads is None:
            payloads = np.zeros_like(keys)
        payloads = np.asarray(payloads, dtype=np.int32)
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} tuples")
        if cap != n:
            pad = cap - n
            keys = np.concatenate([keys, np.full(pad, KEY_SENTINEL, np.int32)])
            payloads = np.concatenate([payloads, np.zeros(pad, np.int32)])
        device = torch.device(device) if device is not None else \
            default_device()
        return cls(torch.tensor(keys, device=device),
                   torch.tensor(payloads, device=device), n, sorted)


class NumaStrategy:
    """Exchange-scheduling order of the multi-shard shuffle, mirroring the
    reference's NEXT/RING/RANDOM NUMA shuffle strategies
    (reference: src/util/numa_shuffle.c:55-85)."""

    NEXT = "NEXT"
    RING = "RING"
    RANDOM = "RANDOM"


@dataclasses.dataclass
class JoinConfig:
    """Mirror of the reference joinconfig_t (src/types.h:88-98)."""

    nthreads: int = 1  # shards of the mesh (parallel/dist_mway.py past 1)
    scalar_sort: bool = False  # torch.sort instead of K1 + K2
    scalar_merge: bool = False  # torch.sort + tagged-cumsum count instead
    mwaybufsize_bytes: int = 0  # -m: the m-way's K2 merge tile; 0: derived
    materialize: bool = False  # produce output tuples (m-way only)


@dataclasses.dataclass
class ThreadResult:
    """Per-shard results (reference threadresult_t, src/types.h:61-68)."""

    nresults: int
    results: Optional[Relation]
    shard_id: int


@dataclasses.dataclass
class JoinResult:
    """Join result and per-phase timing (reference result_t,
    src/types.h:70-80, and joincommon.c:175-196)."""

    totalresults: int
    resultlist: list
    phases: dict  # phase name -> seconds
    throughput: float = 0.0  # (|R| + |S|) / seconds, joincommon.c:214-227
    # phase name -> device bytes moved (read + write), from the shapes
    bytes_moved: dict = dataclasses.field(default_factory=dict)
