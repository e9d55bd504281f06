"""The plain reference agrees with brute force."""

from collections import Counter

import numpy as np
import pytest
import torch

from joinbench import reference


def _relations(seed, n_r, n_s, lo, hi):
    rng = np.random.default_rng(seed)
    rk = rng.integers(lo, hi, n_r).astype(np.int32)
    sk = rng.integers(lo, hi, n_s).astype(np.int32)
    sp = rng.integers(-2**31, 2**31 - 1, n_s).astype(np.int32)
    return rk, sk, sp


def _brute_count(rk, sk):
    cr = Counter(rk.tolist())
    return sum(cr[k] for k in sk.tolist())


def _brute_rows(rk, sk, sp):
    cr = Counter(rk.tolist())
    out = []
    for k, p in zip(sk.tolist(), sp.tolist()):
        out += [(k, p)] * cr[k]
    return sorted(out)


CASES = [(1, 300, 500, 1, 400), (2, 1000, 200, -50, 50),
         (3, 64, 5000, 1, 30), (4, 1, 1, 7, 8), (5, 500, 500, -2**31 + 2, -2**31 + 40)]


@pytest.mark.parametrize("seed,n_r,n_s,lo,hi", CASES)
def test_count_is_brute_force(seed, n_r, n_s, lo, hi, monkeypatch):
    monkeypatch.setattr(reference, "CHUNK", 97)  # many chunks
    rk, sk, _ = _relations(seed, n_r, n_s, lo, hi)
    got = reference.count(torch.from_numpy(rk), torch.from_numpy(sk))
    assert got == _brute_count(rk, sk)


@pytest.mark.parametrize("seed,n_r,n_s,lo,hi", CASES)
def test_rows_are_brute_force(seed, n_r, n_s, lo, hi, monkeypatch):
    monkeypatch.setattr(reference, "CHUNK", 97)
    rk, sk, sp = _relations(seed, n_r, n_s, lo, hi)
    packed = reference.rows(torch.from_numpy(rk), torch.from_numpy(sk),
                            torch.from_numpy(sp))
    keys, pays = reference.unpack(packed)
    assert list(zip(keys.tolist(), pays.tolist())) == _brute_rows(rk, sk, sp)


def test_pack_orders_signed_pairs():
    k = torch.tensor([-5, -5, 3, 3, 2**31 - 1], dtype=torch.int32)
    p = torch.tensor([2**31 - 1, -2**31, 0, -1, 5], dtype=torch.int32)
    packed = reference.pack(k, p)
    order = torch.argsort(packed).tolist()
    assert order == sorted(range(5), key=lambda i: (int(k[i]), int(p[i])))
    uk, up = reference.unpack(packed)
    assert torch.equal(uk, k) and torch.equal(up, p)


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for name in ("reference.py", "check.py", "gen.py"):
        tree = ast.parse((Path(reference.__file__).parent / name).read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.level == 0]
        tops = {m.split(".")[0] for m in mods}
        assert tops <= {"__future__", "dataclasses", "typing", "numpy",
                        "torch"}, tops
