"""ctypes bindings of the native Knuth shuffle and Zipf loops in the
repository's ``csrc/datagen.c`` and of the ``.tbl`` reader and writer in
``csrc/tblio.cc`` (counterpart of
``avx_sort_merge_joins_tpu/datagen/native.py:27-184``).

The unchanged sources are compiled on first use with the system C and C++
compilers into the port's own build directory (``csrc/build/`` inside this
package).
Python's :class:`~.c_rng.GlibcRand` owns the RNG state; its 31-word history
is passed by pointer, so the NumPy and native paths interleave bit-exactly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .c_rng import GlibcRand

_lock = threading.Lock()
_lib = None
_tried = False

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "csrc", "build")


def _compile(source: str, lib: str, compiler: list[str]) -> str:
    """Compile ``csrc/<source>`` into ``<lib>`` in the build directory
    unless it is there and newer; returns the library's path."""
    src = os.path.abspath(os.path.join(_CSRC, source))
    out_dir = os.path.abspath(_BUILD_DIR)
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, lib)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run([*compiler, "-shared", "-fPIC", src, "-o", tmp],
                   check=True, capture_output=True)
    os.replace(tmp, so)
    return so


def _build() -> str:
    return _compile("datagen.c", "libsmjdatagen.so",
                    [os.environ.get("CC", "cc"), "-O3"])


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.CalledProcessError):
            return None  # no C compiler or source: the NumPy path is used
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.knuth_shuffle_i32.argtypes = [i32p, ctypes.c_int64, u32p]
        lib.alphabet_shuffle_i64.argtypes = [i64p, ctypes.c_int64, u32p]
        lib.zipf_fill_i32.argtypes = [f64p, i64p, ctypes.c_int64, i32p,
                                      ctypes.c_int64, u32p]
        for fn in (lib.knuth_shuffle_i32, lib.alphabet_shuffle_i64,
                   lib.zipf_fill_i32):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _hist(rng: GlibcRand) -> np.ndarray:
    h = np.ascontiguousarray(rng._hist, dtype=np.uint32)
    rng._hist = h  # share the buffer so C-side updates persist
    return h


def knuth_shuffle(keys: np.ndarray, rng: GlibcRand) -> None:
    """In-place Knuth shuffle of int32 ``keys`` with glibc draws from
    ``rng`` (generator.c:51-66)."""
    lib = _load()
    if keys.dtype != np.int32 or not keys.flags.c_contiguous:
        raise ValueError("knuth_shuffle needs a contiguous int32 array")
    lib.knuth_shuffle_i32(keys, keys.shape[0], _hist(rng))


def alphabet_shuffle(alphabet: np.ndarray, rng: GlibcRand) -> None:
    """In-place Fisher-Yates of the int64 Zipf alphabet with genzipf's
    ``k = i * rand() / RAND_MAX`` (genzipf.c:43-51)."""
    lib = _load()
    if alphabet.dtype != np.int64 or not alphabet.flags.c_contiguous:
        raise ValueError("alphabet_shuffle needs a contiguous int64 array")
    lib.alphabet_shuffle_i64(alphabet, alphabet.shape[0], _hist(rng))


def zipf_fill(lut: np.ndarray, alphabet: np.ndarray, n: int,
              rng: GlibcRand) -> np.ndarray:
    """``n`` Zipf draws: the first ``lut`` entry >= rand()/RAND_MAX picks
    the alphabet letter (genzipf.c:97-159).  Returns int32 keys."""
    lib = _load()
    out = np.empty(n, dtype=np.int32)
    alphabet = np.ascontiguousarray(alphabet, np.int64)
    lib.zipf_fill_i32(np.ascontiguousarray(lut, np.float64), alphabet,
                      alphabet.shape[0], out, n, _hist(rng))
    return out


# --------------------------------------------------------------------------
# .tbl reader and writer (csrc/tblio.cc)
# --------------------------------------------------------------------------

_tblio_lib = None
_tblio_tried = False
TBLIO_THREADS = 8  # writer threads, as the JAX package's binding passes


def _load_tblio():
    global _tblio_lib, _tblio_tried
    with _lock:
        if _tblio_lib is not None or _tblio_tried:
            return _tblio_lib
        _tblio_tried = True
        try:
            lib = ctypes.CDLL(_compile(
                "tblio.cc", "libsmjtblio.so",
                [os.environ.get("CXX", "g++"), "-O3", "-std=c++17",
                 "-pthread"]))
        except (OSError, subprocess.CalledProcessError):
            return None  # no C++ compiler or source: the text path is used
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        for fn in (lib.tbl_write, lib.tbl_append):
            fn.argtypes = [ctypes.c_char_p, i32p, i32p, ctypes.c_int64,
                           ctypes.c_int]
            fn.restype = ctypes.c_int
        lib.tbl_read.argtypes = [ctypes.c_char_p, i32p, i32p, ctypes.c_int64]
        lib.tbl_read.restype = ctypes.c_int64
        _tblio_lib = lib
        return _tblio_lib


def tblio_available() -> bool:
    return _load_tblio() is not None


def _tbl_put(fn_name: str, path: str, keys: np.ndarray,
             payloads: np.ndarray) -> None:
    keys = np.ascontiguousarray(keys, np.int32)
    payloads = np.ascontiguousarray(payloads, np.int32)
    rc = getattr(_load_tblio(), fn_name)(path.encode(), keys, payloads,
                                         keys.shape[0], TBLIO_THREADS)
    if rc != 0:
        raise IOError(f"{fn_name}({path}) failed with {rc}")


def tbl_write(path: str, keys: np.ndarray, payloads: np.ndarray) -> None:
    """Write "key payload" rows as a new .tbl file."""
    _tbl_put("tbl_write", path, keys, payloads)


def tbl_append(path: str, keys: np.ndarray, payloads: np.ndarray) -> None:
    """Append rows to an existing (or new) .tbl file."""
    _tbl_put("tbl_append", path, keys, payloads)


def tbl_read(path: str, cap: int):
    """Read at most ``cap`` rows of a .tbl file; returns (keys, payloads)."""
    keys = np.empty(cap, np.int32)
    payloads = np.empty(cap, np.int32)
    n = _load_tblio().tbl_read(path.encode(), keys, payloads, cap)
    if n < 0:
        raise IOError(f"tbl_read({path}) failed with {n}")
    return keys[:n], payloads[:n]
