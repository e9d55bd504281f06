"""Zipf-distributed keys, a replica of the reference's genzipf
(counterpart of ``avx_sort_merge_joins_tpu/datagen/genzipf.py``;
reference: src/datagen/genzipf.c).

Bit-exact with the reference when driven by the glibc-rand replica:
  1. alphabet = a permutation of 1..alphabet_size, Fisher-Yates with
     ``k = i * rand() / RAND_MAX`` in integer division (genzipf.c:28-53),
  2. the cumulative-probability table ``lut[i-1] = (sum 1/j^z, j<=i) /
     scale`` (genzipf.c:60-92),
  3. each draw: r = rand()/RAND_MAX, the first table entry >= r, and the
     alphabet letter at that position (genzipf.c:97-159).

From 65,536 letters or draws on, steps 1 and 3 run in the unchanged root
``csrc/datagen.c`` (``datagen.native``), on the same generator state, so
both paths give the same stream.
"""

from __future__ import annotations

import numpy as np

from . import native
from .c_rng import RAND_MAX, GlibcRand

NATIVE_MIN = 65536  # alphabet or stream size from which C does the loop


def gen_alphabet(size: int, rng: GlibcRand) -> np.ndarray:
    """Random permutation of 1..size, exactly as genzipf.c:28-53."""
    alphabet = np.arange(1, size + 1, dtype=np.int64)
    if size <= 1:
        return alphabet
    if size >= NATIVE_MIN and native.available():
        native.alphabet_shuffle(alphabet, rng)
        return alphabet
    draws = rng.rand_array(size - 1)
    for idx, i in enumerate(range(size - 1, 0, -1)):
        k = (i * int(draws[idx])) // RAND_MAX
        alphabet[i], alphabet[k] = alphabet[k], alphabet[i]
    return alphabet


def gen_zipf_lut(zipf_factor: float, alphabet_size: int) -> np.ndarray:
    """Cumulative Zipf table (genzipf.c:60-92)."""
    weights = 1.0 / np.power(np.arange(1, alphabet_size + 1,
                                       dtype=np.float64), zipf_factor)
    csum = np.cumsum(weights)
    return csum / csum[-1]


def gen_zipf(stream_size: int, alphabet_size: int, zipf_factor: float,
             rng: GlibcRand) -> np.ndarray:
    """``stream_size`` Zipf-distributed int32 keys over 1..alphabet_size.

    The reference's binary search returns the smallest index with
    ``lut[pos] >= r``, which is ``np.searchsorted(lut, r, side='left')``
    (genzipf.c:120-146; r <= 1.0 = lut[-1], so pos is in range).
    """
    alphabet = gen_alphabet(alphabet_size, rng)
    lut = gen_zipf_lut(zipf_factor, alphabet_size)
    if stream_size >= NATIVE_MIN and native.available():
        return native.zipf_fill(lut, alphabet, stream_size, rng)
    draws = rng.rand_array(stream_size).astype(np.float64) / float(RAND_MAX)
    pos = np.minimum(np.searchsorted(lut, draws, side="left"),
                     alphabet_size - 1)
    return alphabet[pos].astype(np.int32)
