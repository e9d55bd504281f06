"""The benchmark's one traffic generator: the relations of a cell, made on
the device from ``--seed`` in the shapes of the reference's generators
(Balkesen et al., src/datagen/generator.c and genzipf.c), and handed to
both the program and the plain reference.

Tuples are ``<key, payload>`` of the configuration's ``"key_bytes"`` (4
when absent: int32 columns; 8: int64 columns, the reference's KEY_8B
tuple, types.h:23-29, whose key values are those of KEY_4B); the payload
is the row id the tuple had before the shuffle, as the reference's
generators number them.

* R: the keys 1..|R| shuffled (``random_unique_gen``, knuth shuffle).
* S ``"tiling"``: the keys 1..|R| tiled to |S| and shuffled
  (``parallel_create_relation(|S|, |R|)``).
* S ``"zipf"``: |S| draws of Zipf(z) over a shuffled alphabet 1..|R|
  (genzipf.c: the alphabet's permutation, the cumulative table of
  ``1/k^z``, the first table entry at or past a uniform draw).

A shuffle of n rows is a keyed bijection of [0, n), evaluated a chunk at
a time: a Feistel network over the bits of n - 1 with cycle walking, in
int64 arithmetic.  The same seed gives the same relations on
a device of the same kind; no n-entry permutation is ever held.  The Zipf
table is the reference's per-key table, built on the device in float64 a
chunk at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

CHUNK = 1 << 26  # rows a generator pass
_MASK32 = (1 << 32) - 1
# odd multipliers below 2^31, so that a 32-bit word times one fits int64
_MULS = (0x7FEB352D, 0x68E31DA5, 0x2C1B3C6D, 0x297A2D39)
# stream tags: each relation's shuffle and draws get keys of their own
STREAM_R, STREAM_S, STREAM_ALPHABET, STREAM_DRAWS = 1, 2, 3, 4
KEY_DTYPES = {4: torch.int32, 8: torch.int64}  # key_bytes -> column type


def stream_seed(seed: int, stream: int, words: int = 1) -> list[int]:
    """``words`` 32-bit words mixed from the run's seed and a stream tag."""
    ss = np.random.SeedSequence([int(seed) % 2**64, stream])
    return [int(w) for w in ss.generate_state(words, np.uint32)]


class Bijection:
    """A keyed permutation of [0, n): ``self(idx)`` maps int64 indices to
    their images.  A Feistel network over b = bits(n - 1) bits, cut into a
    high half of b // 2 bits and a low half of the rest; six half-rounds
    each xor one half with a 32-bit multiply-xorshift mix of the other and
    the round's key.  Images that land in [n, 2^b) walk the network again
    until they land inside (2^b < 2n, so under two passes expected)."""

    ROUNDS = 6

    def __init__(self, n: int, seed: int, stream: int):
        if n < 1:
            raise ValueError(f"Bijection of {n} elements")
        self.n = n
        bits = max(2, (n - 1).bit_length())
        self.lo_bits = bits - bits // 2
        self.lo_mask = (1 << self.lo_bits) - 1
        self.hi_mask = (1 << (bits // 2)) - 1
        self.keys = stream_seed(seed, stream, self.ROUNDS)

    @staticmethod
    def _mix(half: torch.Tensor, key: int, mul: int) -> torch.Tensor:
        f = ((half ^ key) * mul) & _MASK32
        f ^= f >> 15
        f = (f * _MULS[0]) & _MASK32
        f ^= f >> 13
        return f

    def _network(self, x: torch.Tensor) -> torch.Tensor:
        hi, lo = x >> self.lo_bits, x & self.lo_mask
        for i, key in enumerate(self.keys):
            mul = _MULS[i % len(_MULS)]
            if i % 2:
                lo = lo ^ (self._mix(hi, key, mul) & self.lo_mask)
            else:
                hi = hi ^ (self._mix(lo, key, mul) & self.hi_mask)
        return (hi << self.lo_bits) | lo

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        y = self._network(idx)
        todo = torch.nonzero(y >= self.n).squeeze(1)
        while todo.numel():
            z = self._network(y[todo])
            y[todo] = z
            todo = todo[z >= self.n]
        return y


@dataclasses.dataclass
class Relations:
    """A cell's R and S on one device: flat int32 or int64 columns of
    ``n_r`` and ``n_s`` rows; payload columns only where the cell holds
    them."""

    n_r: int
    n_s: int
    r_keys: torch.Tensor
    s_keys: torch.Tensor
    r_payloads: Optional[torch.Tensor]
    s_payloads: Optional[torch.Tensor]

    @property
    def device(self) -> torch.device:
        return self.r_keys.device


def _chunks(n: int):
    for lo in range(0, n, CHUNK):
        yield lo, min(n, lo + CHUNK)


def _fill_shuffled(n: int, seed: int, stream: int, modulus: int,
                   keys: torch.Tensor, payloads: Optional[torch.Tensor]):
    """Row i of the shuffled relation: ``p = pi(i)``, key ``p mod modulus
    + 1``, payload ``p`` (the row id before the shuffle)."""
    pi = Bijection(n, seed, stream)
    for lo, hi in _chunks(n):
        p = pi(torch.arange(lo, hi, dtype=torch.int64, device=keys.device))
        if payloads is not None:
            payloads[lo:hi] = p
        keys[lo:hi] = p % modulus + 1


def zipf_cdf(n: int, z: float, device) -> torch.Tensor:
    """The reference's cumulative table of ``1/k^z`` over k = 1..n, float64,
    unnormalised (its last entry is the total); each chunk summed by the
    device's scan, the chunks chained by their running total."""
    cdf = torch.empty(n, dtype=torch.float64, device=device)
    carry = None
    for lo, hi in _chunks(n):
        w = torch.arange(lo + 1, hi + 1, dtype=torch.float64,
                         device=device).pow_(-z)
        torch.cumsum(w, 0, out=cdf[lo:hi])
        if carry is not None:
            cdf[lo:hi] += carry
        carry = cdf[hi - 1]
    return cdf


def _fill_zipf(n_s: int, n_r: int, z: float, seed: int, keys: torch.Tensor,
               payloads: Optional[torch.Tensor]):
    """|S| Zipf(z) draws over the alphabet 1..|R| shuffled: rank r (0 the
    most frequent) is the first table entry at or past ``u * total``, its
    key the alphabet's letter ``pi_A(r) + 1``; payload the row id."""
    dev = keys.device
    cdf = zipf_cdf(n_r, z, dev)
    total = cdf[-1]
    alphabet = Bijection(n_r, seed, STREAM_ALPHABET)
    gen = torch.Generator(device=dev)
    gen.manual_seed(stream_seed(seed, STREAM_DRAWS)[0])
    for lo, hi in _chunks(n_s):
        u = torch.rand(hi - lo, dtype=torch.float64, generator=gen,
                       device=dev)
        rank = torch.searchsorted(cdf, u.mul_(total)).clamp_(max=n_r - 1)
        keys[lo:hi] = alphabet(rank) + 1
        if payloads is not None:
            payloads[lo:hi] = torch.arange(lo, hi, dtype=torch.int32,
                                           device=dev)
    del cdf


def key_bytes(config: dict, traffic: dict) -> int:
    """The configuration's tuple width: ``config["key_bytes"]``, 4 or 8
    bytes a key and as many a payload, 4 when absent.  Row answers are
    packed from int32 halves (``reference.pack``), so a traffic mix that
    asks for rows takes 4 only."""
    kb = int(config.get("key_bytes", 4))
    if kb not in KEY_DTYPES:
        raise ValueError(f"configuration {config.get('name')!r}: key_bytes "
                         f"{kb}, not 4 or 8")
    if kb != 4 and traffic["query"] == "rows":
        raise ValueError(f"configuration {config.get('name')!r}: key_bytes "
                         f"{kb} with {traffic.get('name')!r}, which asks for "
                         "rows: rows are compared as int32 pairs only")
    return kb


def make_relations(n_r: int, n_s: int, traffic: dict, seed: int, device,
                   payloads: bool, key_bytes: int = 4) -> Relations:
    """R and S of a cell on ``device``.  ``traffic["s_keys"]`` is
    ``"tiling"`` or ``"zipf"`` (with ``traffic["zipf_z"]``); ``payloads``
    says whether the payload columns are made; ``key_bytes`` (4 or 8) the
    columns' width.  The values are the same at either width."""
    if not 0 < n_r < 2**31 - 1 or not 0 < n_s < 2**31:
        raise ValueError(f"sizes |R| = {n_r}, |S| = {n_s}: int32 keys and "
                         "row ids need both in 1..2^31 - 2")

    def col(n):
        return torch.empty(n, dtype=KEY_DTYPES[key_bytes], device=device)

    rk, sk = col(n_r), col(n_s)
    rp = col(n_r) if payloads else None
    sp = col(n_s) if payloads else None
    _fill_shuffled(n_r, seed, STREAM_R, n_r, rk, rp)
    kind = traffic["s_keys"]
    if kind == "tiling":
        _fill_shuffled(n_s, seed, STREAM_S, n_r, sk, sp)
    elif kind == "zipf":
        _fill_zipf(n_s, n_r, float(traffic["zipf_z"]), seed, sk, sp)
    else:
        raise ValueError(f"traffic s_keys {kind!r}: not 'tiling' or 'zipf'")
    return Relations(n_r, n_s, rk, sk, rp, sp)
