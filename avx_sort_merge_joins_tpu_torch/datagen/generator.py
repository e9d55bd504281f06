"""Workload generators (counterpart of
``avx_sort_merge_joins_tpu/datagen/generator.py:38-294``; reference:
src/datagen/generator.c).

The same seed gives the same relations as the JAX package:

* ``create_relation_pk`` / ``random_unique_gen``: keys 1..n Knuth-shuffled
  with glibc ``RAND_RANGE`` draws (generator.c:55-93).
* ``parallel_create_relation``: keys ``(i mod maxid) + 1`` and payloads
  ``5 + local_i`` per generating thread, globally shuffled
  (generator.c:125-178,254-350).  Below 2^22 tuples the shuffle is the
  host Knuth shuffle; from 2^22 up the relation is built on ``device`` by
  sorting the same int32 hash draws as the JAX device path, seeded by one
  glibc draw, so both packages build the same relation.
* ``create_relation_fk``: consecutive independently shuffled 1..maxid
  blocks plus a shuffled 1..remainder block (generator.c:407-445).
* ``create_relation_fk_from_pk``: tiled copies of a relation, globally
  Knuth-shuffled (generator.c:452-488).
* ``create_relation_nonunique``: keys = RAND_RANGE(maxid), payload = n - i
  (generator.c:215-231,490-505).
* ``create_relation_zipf``: Zipf-skewed keys from ``genzipf.gen_zipf``
  (generator.c:517-534).
* ``write_relation`` / ``append_rows`` / ``read_relation``: the reference's
  ``.tbl`` text format, one "key payload" pair per line
  (generator.c:200-213), through the native writer when it builds.

Host-built columns are copied to ``device`` once.  The default device is
the card; without one every entry point raises unless it is given
``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..types import Relation, default_device
from .c_rng import RAND_MAX, GlibcRand
from .genzipf import gen_zipf

_global_rng: Optional[GlibcRand] = None

DEVICE_GEN_MIN = 1 << 22  # parallel_create_relation builds on device from here


def seed_generator(seed: int) -> None:
    """Reference seed_generator (generator.c:28-35)."""
    global _global_rng
    _global_rng = GlibcRand(seed)


def _check_seed() -> GlibcRand:
    global _global_rng
    if _global_rng is None:
        _global_rng = GlibcRand(42)  # deterministic default (ref uses time())
    return _global_rng


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else default_device()


def knuth_shuffle_keys(keys: np.ndarray, rng: GlibcRand) -> np.ndarray:
    """In-place Fisher-Yates on keys with j = RAND_RANGE(i) (generator.c:51-66).

    Draw order matches the C loop i = n-1 .. 1 exactly.
    """
    n = keys.shape[0]
    if n <= 1:
        return keys
    if n >= 65536:
        from . import native

        if native.available():
            native.knuth_shuffle(keys, rng)
            return keys
    draws = rng.rand_array(n - 1).astype(np.float64)
    idx = np.arange(n - 1, 0, -1, dtype=np.int64)
    js = (draws / float(RAND_MAX + 1) * idx).astype(np.int64)
    for pos, i in enumerate(range(n - 1, 0, -1)):
        j = js[pos]
        keys[i], keys[j] = keys[j], keys[i]
    return keys


def random_unique_gen(n: int, rng: GlibcRand) -> np.ndarray:
    """Shuffled permutation of 1..n (generator.c:83-93)."""
    keys = np.arange(1, n + 1, dtype=np.int32)
    return knuth_shuffle_keys(keys, rng)


def create_relation_pk(num_tuples: int, capacity: Optional[int] = None,
                       device=None) -> Relation:
    """Primary-key relation: unique shuffled keys 1..n (generator.c:234-252)."""
    rng = _check_seed()
    keys = random_unique_gen(num_tuples, rng)
    payloads = np.arange(5, 5 + num_tuples, dtype=np.int32)
    return Relation.from_numpy(keys, payloads, capacity, _device(device))


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> the int32 value it wraps to (two's complement)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _hash_draws(num_tuples: int, seed: int, device,
                start: int = 0) -> torch.Tensor:
    """The JAX device path's int32 shuffle draws (generator.py:112-115):
    a splitmix-style hash of ``i + seed`` with wrapping int32 multiplies and
    arithmetic shifts, computed exactly in int64; draws ``start`` to
    ``start + num_tuples``."""
    x = _wrap_i32(torch.arange(start, start + num_tuples, dtype=torch.int64,
                               device=device) + seed)
    x = _wrap_i32((x ^ (x >> 16)) * 0x7FEB352D)
    x = _wrap_i32((x ^ (x >> 15)) * (0x846CA68B - 2**32))
    return (x ^ (x >> 16)).to(torch.int32)


GEN_STEP = 1 << 26  # elements a step of the device generation's passes


def _steps(n: int):
    return ((lo, min(n, lo + GEN_STEP)) for lo in range(0, n, GEN_STEP))


def _device_gen(num_tuples: int, maxid: int, nthreads: int, seed: int,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """Keys and payloads of ``parallel_create_relation`` built on
    ``device``: the multiset {1..maxid} tiled to n, ordered by a stable
    sort of the hash draws (the JAX package's ``jax.lax.sort`` of the same
    draws, generator.py:99-122).

    The stable sort runs in four parts, the draws of each quarter of the
    int32 range in signed order, each sorted with its positions ascending:
    together the one stable sort, in about 20 bytes of device memory a
    tuple at the peak, and no ``torch.sort`` past a quarter of the draws
    (it takes at most 2^31 - 1 elements).  The element-wise passes go
    ``GEN_STEP`` elements at a time."""
    n = num_tuples
    draws = torch.empty(n, dtype=torch.int32, device=device)
    for lo, hi in _steps(n):
        draws[lo:hi] = _hash_draws(hi - lo, seed, device, start=lo)
    keys = torch.empty(n, dtype=torch.int32, device=device)
    done = 0
    for quarter in (-2, -1, 0, 1):  # draw >> 30, in signed order
        pos = [torch.nonzero((draws[lo:hi] >> 30) == quarter).squeeze(1)
               + lo for lo, hi in _steps(n)]
        pos = torch.cat(pos) if pos else draws.new_empty(0, dtype=torch.long)
        order = pos[torch.sort(draws[pos], stable=True).indices]
        del pos
        keys[done:done + order.numel()] = (order % maxid + 1).to(torch.int32)
        done += order.numel()
        del order
    del draws
    per = max(n // nthreads, 1)
    payloads = torch.empty(n, dtype=torch.int32, device=device)
    for lo, hi in _steps(n):
        idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
        start = torch.clamp(idx // per, max=nthreads - 1) * (n // nthreads)
        payloads[lo:hi] = (5 + (idx - start)).to(torch.int32)
    return keys, payloads


def parallel_create_relation(
    num_tuples: int,
    maxid: int,
    nthreads: int = 1,
    capacity: Optional[int] = None,
    on_device: Optional[bool] = None,
    device=None,
) -> Relation:
    """Unique-key relation built the way the reference's parallel generator
    does (generator.c:254-350): thread t's chunk holds consecutive keys
    starting at its offset (wrapping at maxid) and payloads 5+local_i; keys
    are then globally shuffled.  The multiset equals {1..maxid} tiled to n.

    The reference's parallel shuffle seeds each thread from the clock
    (generator.c:137), so only the key multiset is defined.  From
    ``DEVICE_GEN_MIN`` tuples up (or with ``on_device=True``) the relation
    is built on ``device`` from one glibc draw, as the JAX package does;
    ``on_device=False`` forces the host Knuth shuffle.
    """
    device = _device(device)
    nthreads = max(nthreads, 1)
    if on_device is None:
        on_device = num_tuples >= DEVICE_GEN_MIN
    rng = _check_seed()
    if on_device:
        if capacity not in (None, num_tuples):
            raise ValueError("the device path builds unpadded relations")
        keys, payloads = _device_gen(num_tuples, maxid, nthreads,
                                     rng.rand() & 0x7FFFFFFF, device)
        return Relation(keys, payloads, num_tuples)
    base = np.arange(num_tuples, dtype=np.int64) % maxid + 1
    keys = base.astype(np.int32)
    knuth_shuffle_keys(keys, rng)
    # payload = 5 + index within the generating thread's chunk
    per = num_tuples // nthreads
    idx = np.arange(num_tuples, dtype=np.int64)
    chunk_start = np.minimum(idx // max(per, 1), nthreads - 1) * per
    payloads = (5 + (idx - chunk_start)).astype(np.int32)
    return Relation.from_numpy(keys, payloads, capacity, device)


def create_relation_fk(num_tuples: int, maxid: int,
                       capacity: Optional[int] = None,
                       device=None) -> Relation:
    """Foreign-key relation: independently shuffled full 1..maxid blocks plus
    a shuffled 1..remainder block (generator.c:407-445)."""
    rng = _check_seed()
    iters = num_tuples // maxid
    parts = [random_unique_gen(maxid, rng) for _ in range(iters)]
    rem = num_tuples % maxid
    if rem > 0:
        parts.append(random_unique_gen(rem, rng))
    keys = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    payloads = np.arange(5, 5 + num_tuples, dtype=np.int32)
    return Relation.from_numpy(keys, payloads, capacity, _device(device))


def create_relation_fk_from_pk(pk: Relation, num_tuples: int,
                               capacity: Optional[int] = None,
                               device=None) -> Relation:
    """FK relation as tiled copies of the PK relation, globally shuffled
    (generator.c:452-488).  The keys take the shuffle; the payloads stay
    in tiled order, as in the JAX package."""
    rng = _check_seed()
    pkk, pkp = pk.to_numpy()
    reps = -(-num_tuples // pk.num_tuples)
    keys = np.tile(pkk, reps)[:num_tuples].copy()
    payloads = np.tile(pkp, reps)[:num_tuples].copy()
    knuth_shuffle_keys(keys, rng)
    return Relation.from_numpy(keys, payloads, capacity, _device(device))


def create_relation_nonunique(num_tuples: int, maxid: int,
                              capacity: Optional[int] = None,
                              device=None) -> Relation:
    """Uniform random keys in [0, maxid), payload = n - i
    (generator.c:215-231, RAND_RANGE generator.c:22)."""
    rng = _check_seed()
    draws = rng.rand_array(num_tuples).astype(np.float64)
    keys = (draws / float(RAND_MAX + 1) * maxid).astype(np.int32)
    payloads = (num_tuples - np.arange(num_tuples, dtype=np.int64)).astype(
        np.int32)
    return Relation.from_numpy(keys, payloads, capacity, _device(device))


def create_relation_zipf(num_tuples: int, maxid: int, zipf_param: float,
                         capacity: Optional[int] = None,
                         device=None) -> Relation:
    """Zipf-skewed foreign-key relation over 1..maxid, payloads 5.. in
    order (generator.c:517-534, genzipf.c)."""
    keys = gen_zipf(num_tuples, maxid, zipf_param, _check_seed())
    payloads = np.arange(5, 5 + num_tuples, dtype=np.int32)
    return Relation.from_numpy(keys, payloads, capacity, _device(device))


def _write_rows(path: str, mode: str, keys: np.ndarray,
                payloads: np.ndarray) -> None:
    """Write (mode "w") or append (mode "a") "key payload" rows.  Whether
    the native writer (csrc/tblio.cc) is there is probed before anything is
    written, and a write that fails raises: falling back after a partial
    native write would duplicate rows and hide the I/O error."""
    from . import native

    if native.tblio_available():
        (native.tbl_write if mode == "w" else native.tbl_append)(
            path, keys, payloads)
        return
    with open(path, mode) as f:
        for k, p in zip(np.asarray(keys).tolist(),
                        np.asarray(payloads).tolist()):
            f.write(f"{k} {p}\n")


def write_relation(rel: Relation, path: str) -> None:
    """Persist a relation in the reference's .tbl text format
    (generator.c:200-213): one "key payload" pair per line."""
    _write_rows(path, "w", *rel.to_numpy())


def append_rows(path: str, keys: np.ndarray, payloads: np.ndarray) -> None:
    """Append "key payload" rows to a .tbl file, so that an output can be
    written chunk by chunk."""
    _write_rows(path, "a", keys, payloads)


def read_relation(path: str, capacity: Optional[int] = None,
                  device=None) -> Relation:
    """Load a .tbl file back into a Relation.  A read that fails raises
    (the JAX package falls back to its text parser on any error of the
    native reader)."""
    from . import native

    if native.tblio_available():
        # every row takes at least 4 bytes ("k p\n")
        cap = capacity or max(1, os.path.getsize(path) // 4)
        keys, payloads = native.tbl_read(path, cap)
        return Relation.from_numpy(keys, payloads, capacity,
                                   _device(device))
    ks, ps = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                ks.append(int(parts[0]))
                ps.append(int(parts[1]))
    return Relation.from_numpy(np.asarray(ks, np.int32),
                               np.asarray(ps, np.int32), capacity,
                               _device(device))
