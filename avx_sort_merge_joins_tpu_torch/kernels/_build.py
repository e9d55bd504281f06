"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source in the package's ``csrc/``
for ``sm_90a`` (Hopper), one process per source, all started together,
and links the objects into one shared library with a plain C interface,
which ``ctypes`` loads.  Every fresh checkout pays this build, the smoke
run's included, so it takes the slowest source's time, not the sum.  The library lands in ``csrc/build/`` under a name
keyed by a hash of the sources and flags, so an edited source forces a
rebuild and a stale library is never loaded.  Nothing is built at import time: the CPU
path never calls :func:`library`.

Every entry point takes pointers and the stream as ``c_void_p``, sizes as
``c_int64``, and returns ``cudaGetLastError()`` as an int; :func:`check`
turns a non-zero code into an exception.  Two exceptions:
``smj_multiway_merge_scratch`` returns a size and
``smj_corank_fallbacks`` returns a count (``_RESTYPES``); the
``*_occupancy`` entry points write a count into a host int (``_IP``).
Every kernel launch goes through :func:`launch`, which counts it by kernel
id (:func:`launches`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_IP = ctypes.POINTER(ctypes.c_int)  # a host int the entry point fills
# entry point -> argument types (see the SMJ_API functions in csrc/*.cu)
_SIGNATURES = {
    "smj_block_sort": (_P, _P, _L, _I, _I, _P),
    "smj_block_sort_occupancy": (_I, _IP),
    "smj_block_sort_pairs": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
    "smj_block_sort_pairs_occupancy": (_I, _IP),
    "smj_multiway_merge": (_P, _P, _P, _P, _P, _L, _L, _L, _L, _I, _I, _I,
                           _P),
    "smj_multiway_merge_varlen": (_P, _P, _P, _P, _P, _L, _L, _P, _L, _L, _I,
                                  _I, _I, _P),
    "smj_multiway_merge_scratch": (_L, _L, _I, _I),
    "smj_multiway_merge_occupancy": (_I, _I, _IP),
    "smj_corank_fallbacks": (_I,),
    "smj_chunk_gated_merge": (_P, _P, _P, _P, _P, _L, _P, _L, _L, _L, _I,
                              _I, _I, _P),
    "smj_chunk_gated_merge_tile": (),
    "smj_merge_pass": (_P, _P, _P, _P, _L, _L, _L, _I, _P),
    "smj_merge_pass_varlen": (_P, _P, _P, _P, _P, _L, _L, _P),
    "smj_merge_pass_occupancy": (_I, _IP),
    "smj_merge_join_count": (_P, _L, _P, _L, _P, _P),
    "smj_merge_join_count64": (_P, _P, _L, _P, _P, _L, _P, _P),
    "smj_merge_join_count2": (_P, _L, _P, _L, _L, _L, _P, _P),
    "smj_radix_hist": (_P, _L, _I, _I, _I, _P, _P),
    "smj_radix_hist_occupancy": (_I, _IP),
    "smj_remote_pull": (_P, _P, _I, _L, _L, _I, _L, _I, _P),
    "smj_remote_pull_occupancy": (_I, _IP),
    "smj_enable_peer_access": (_I, _I),
}

# entry points that return something else than a cudaError_t code
_RESTYPES = {"smj_multiway_merge_scratch": ctypes.c_int64,
             "smj_corank_fallbacks": ctypes.c_int64}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# launches by kernel id ("K1" .. "K11"), and K2's tiles ("K2.tile<t>") and
# searched fine co-ranks ("K2.search"), since the last reset_launches()
_launches: collections.Counter = collections.Counter()
build_seconds: float | None = None  # wall time of the last nvcc build


def sources() -> list[str]:
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def _digest(paths: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; wait for every one; raise with the
    output of those that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"{' '.join(c)} -> {p.returncode}\n{out}"
              for c, p, out in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> str:
    """Compile ``csrc/*.cu`` into the keyed library unless it exists;
    returns its path.  Raises with nvcc's output when the build fails."""
    global build_seconds
    srcs = sources()
    key = _digest(srcs)
    so = os.path.join(BUILD_DIR, f"libsmj_kernels-{key}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{key}.{os.getpid()}"
    cus = [s for s in srcs if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}-{tag}.o")
            for s in cus]
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                  for s, o in zip(cus, objs)])
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            with contextlib.suppress(FileNotFoundError):
                os.remove(o)
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            lib.smj_error_string.argtypes = [ctypes.c_int]
            lib.smj_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, code: int) -> None:
    """Raise when a kernel entry point reports a CUDA error code."""
    if code != 0:
        text = library().smj_error_string(code).decode()
        raise RuntimeError(f"{name} failed with cudaError {code}: {text}")


def launch(keys, entry: str, t, *args) -> None:
    """Launch the kernel entry point ``entry`` on tensor ``t``'s card, as
    PyTorch's own kernels do: that card made current, ``args`` then its
    current stream.  Raises through :func:`check`; when the launch
    succeeded, counts 1 under each of ``keys``, a kernel id or a tuple of
    them."""
    import torch

    with torch.cuda.device(t.device):
        code = getattr(library(), entry)(
            *args, torch.cuda.current_stream().cuda_stream)
    check(entry, code)
    _launches.update((keys,) if isinstance(keys, str) else keys)


def launches() -> collections.Counter:
    """A copy of the launch count by key (0 for a key never counted)."""
    return collections.Counter(_launches)


def reset_launches() -> None:
    """Empty the launch count."""
    _launches.clear()
