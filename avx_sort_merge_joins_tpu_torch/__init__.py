"""avx_sort_merge_joins_tpu_torch -- the sort-merge-join engine on PyTorch
and hand-written CUDA kernels for the NVIDIA H100.

A port of ``avx_sort_merge_joins_tpu`` (JAX and Pallas on a TPU), which
stays beside it as the reference.  This package imports ``torch`` and
numpy, never JAX.  Ported so far: the single-device m-way, m-pass and mpsm
count joins (m-way also on the two-run ``SMJ_COUNT2`` route), the
materializing m-way join, the KEY_8B (64-bit key) count join, the (key,
payload) pair sorts, the 2-way merge facade, the tag-merge count, radix
partitioning, Zipf data and the micro-benchmarks (``bench``), with the
block sorts (K1 keys, K5 pairs), multiway merges (K2 keys, K6 pairs),
pairwise merge pass (K4), match counts (K3 int32 keys, K7 64-bit keys, K10
two runs a side) and the radix histogram (K8) as CUDA C++ kernels for
``sm_90a`` in ``csrc/``.
"""

import importlib

from .types import JoinConfig, JoinResult, Relation  # noqa: F401

__version__ = "0.1.0"

_SUBMODULES = ("datagen", "ops", "models", "utils", "kernels", "bench")


def __getattr__(name):
    """Lazy submodule access (``smj.datagen``, ``smj.models`` ...)."""
    if name in _SUBMODULES:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
