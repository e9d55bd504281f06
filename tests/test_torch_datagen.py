"""Datagen parity of the PyTorch port against the JAX package: the same
seed must give bit-identical glibc streams and identical relations, on the
host paths and on the device path (run on the CPU here)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avx_sort_merge_joins_tpu import datagen as jdg
from avx_sort_merge_joins_tpu.datagen import generator as jgen
from avx_sort_merge_joins_tpu_torch import datagen as tdg
from avx_sort_merge_joins_tpu_torch.datagen import generator as tgen
from avx_sort_merge_joins_tpu_torch.types import Relation

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1, 2**32 + 7])
def test_glibc_rand_streams_bit_exact(seed):
    j, t = jdg.GlibcRand(seed), tdg.GlibcRand(seed)
    assert j.rand() == t.rand()
    np.testing.assert_array_equal(j.rand_array(5000), t.rand_array(5000))
    assert j.rand() == t.rand()


def _pair(make_jax, make_torch, seed):
    jdg.seed_generator(seed)
    jrel = make_jax()
    tdg.seed_generator(seed)
    trel = make_torch()
    jk, jp = jrel.to_numpy()
    tk, tp = trel.to_numpy()
    assert trel.num_tuples == jrel.num_tuples
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tp, jp)
    return trel


@pytest.mark.parametrize("kind,n,maxid", [
    ("pk", 50_000, None),
    ("pk", 100_000, None),   # >= 65536: the native Knuth shuffle
    ("fk", 30_000, 7_000),   # four full shuffled blocks + a remainder
    ("parallel", 50_000, 50_000),
    ("parallel", 20_000, 3_000),
    ("nonunique", 50_000, 9_999),
])
def test_host_relations_match(kind, n, maxid):
    if kind == "pk":
        makers = (lambda: jdg.create_relation_pk(n),
                  lambda: tdg.create_relation_pk(n, device=CPU))
    elif kind == "fk":
        makers = (lambda: jdg.create_relation_fk(n, maxid),
                  lambda: tdg.create_relation_fk(n, maxid, device=CPU))
    elif kind == "parallel":
        makers = (lambda: jdg.parallel_create_relation(n, maxid, 3,
                                                       device=False),
                  lambda: tdg.parallel_create_relation(
                      n, maxid, 3, on_device=False, device=CPU))
    else:
        makers = (lambda: jdg.create_relation_nonunique(n, maxid),
                  lambda: tdg.create_relation_nonunique(n, maxid,
                                                        device=CPU))
    rel = _pair(*makers, seed=4242)
    assert rel.keys.dtype == torch.int32 and rel.keys.device == CPU


def _jax_hash_draws(n, seed):
    """The JAX device path's draws, as written in generator.py:112-115."""
    x = jnp.arange(n, dtype=jnp.int32) + jnp.int32(seed)
    x = (x ^ (x >> 16)) * jnp.int32(0x7feb352d)
    x = (x ^ (x >> 15)) * jnp.int32(np.int32(np.uint32(0x846ca68b)))
    return np.asarray(x ^ (x >> 16))


@pytest.mark.parametrize("seed", [0, 987654321, 2**31 - 1 - 100])
def test_device_path_hash_draws_bit_exact(seed):
    n = 1 << 16
    got = tgen._hash_draws(n, seed, CPU).numpy()
    np.testing.assert_array_equal(got, _jax_hash_draws(n, seed))


@pytest.mark.parametrize("maxid,nthreads", [(1 << 16, 1), (20_000, 3)])
def test_device_path_relation_matches(maxid, nthreads):
    n = 1 << 16
    _pair(lambda: jdg.parallel_create_relation(n, maxid, nthreads,
                                               device=True),
          lambda: tdg.parallel_create_relation(n, maxid, nthreads,
                                               on_device=True, device=CPU),
          seed=12345)
    # near 2^31 the seed wraps and ~100 draws collide: both sorts are
    # stable, so tied draws keep index order on both sides
    for seed in (77, 2**31 - 101):
        keys, payloads = tgen._device_gen(n, maxid, nthreads, seed, CPU)
        jk, jp = jgen._device_gen(n, maxid, nthreads)(jnp.int32(seed))
        np.testing.assert_array_equal(keys.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(payloads.numpy(), np.asarray(jp))


def test_device_path_is_the_default_from_2_22():
    assert tgen.DEVICE_GEN_MIN == 1 << 22
    with pytest.raises(ValueError):
        tdg.parallel_create_relation(16, 16, on_device=True, capacity=32,
                                     device=CPU)


def test_relation_from_numpy_pads_and_round_trips():
    keys = np.array([5, -3, 9], np.int32)
    rel = Relation.from_numpy(keys, capacity=6, device=CPU)
    assert rel.capacity == 6 and rel.num_tuples == 3
    assert rel.keys[3:].tolist() == [2**31 - 1] * 3
    assert rel.payloads.tolist() == [0] * 6
    k, p = rel.to_numpy()
    np.testing.assert_array_equal(k, keys)
    with pytest.raises(ValueError):
        Relation.from_numpy(keys, capacity=2, device=CPU)


@pytest.mark.parametrize("maker", [
    lambda **kw: tdg.create_relation_pk(100, **kw),
    lambda **kw: tdg.create_relation_fk(100, 30, **kw),
    lambda **kw: tdg.create_relation_nonunique(100, 30, **kw),
    lambda **kw: tdg.create_relation_zipf(100, 30, 1.0, **kw),
    lambda **kw: tdg.parallel_create_relation(100, 100, 2, **kw),
    lambda **kw: tdg.parallel_create_relation(100, 100, 2, on_device=True,
                                              **kw),
    lambda **kw: Relation.from_numpy(np.arange(100, dtype=np.int32), **kw),
], ids=["pk", "fk", "nonunique", "zipf", "parallel",
        "parallel_device_path", "from_numpy"])
def test_datagen_without_a_card_needs_the_cpu_named(maker, monkeypatch):
    """No silent CPU: without a card every generator, and
    ``Relation.from_numpy``, raises unless it is given device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tdg.seed_generator(5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        maker()
    tdg.seed_generator(5)
    rel = maker(device="cpu")
    assert rel.keys.device == CPU and rel.num_tuples == 100


@pytest.mark.parametrize("n_pk,n_fk", [(5000, 12_345), (70_000, 70_001),
                                       (300, 100)])
def test_fk_from_pk_matches(n_pk, n_fk):
    """Tiled copies of a full-range relation, Knuth-shuffled (host shuffle
    below 65,536 keys, the native one from there on)."""
    def make(dg, **kw):
        pk = dg.create_relation_nonunique(n_pk, 2**31 - 1, **kw)
        dg.seed_generator(n_fk)
        return dg.create_relation_fk_from_pk(pk, n_fk, **kw)

    trel = _pair(lambda: make(jdg), lambda: make(tdg, device=CPU), seed=n_pk)
    assert trel.num_tuples == n_fk


@pytest.mark.parametrize("native_writer", [True, False],
                         ids=["native", "text"])
def test_tbl_files_round_trip_and_match_jax(native_writer, tmp_path,
                                            monkeypatch):
    from avx_sort_merge_joins_tpu.datagen import native as jnative
    from avx_sort_merge_joins_tpu_torch.datagen import native as tnative

    if native_writer:
        assert tnative.tblio_available() and jnative.tblio_available()
    else:
        monkeypatch.setattr(tnative, "tblio_available", lambda: False)
        monkeypatch.setattr(jnative, "tblio_available", lambda: False)
    rng = np.random.default_rng(3)
    keys = rng.integers(-(2**31) + 2, 2**31 - 1, 5000).astype(np.int32)
    keys[:2] = (-(2**31) + 2, 2**31 - 2)
    pays = rng.integers(-(2**31), 2**31, 5000).astype(np.int32)
    tpath, jpath = str(tmp_path / "t.tbl"), str(tmp_path / "j.tbl")
    tgen.write_relation(Relation.from_numpy(keys[:3000], pays[:3000],
                                            device=CPU), tpath)
    tgen.append_rows(tpath, keys[3000:], pays[3000:])
    jdg.write_relation(jdg.generator.Relation.from_numpy(keys[:3000],
                                                         pays[:3000]), jpath)
    jdg.append_rows(jpath, keys[3000:], pays[3000:])
    with open(tpath, "rb") as t, open(jpath, "rb") as j:
        assert t.read() == j.read()
    back = tgen.read_relation(tpath, device=CPU)
    assert back.num_tuples == 5000
    np.testing.assert_array_equal(back.to_numpy()[0], keys)
    np.testing.assert_array_equal(back.to_numpy()[1], pays)


def test_tbl_read_of_a_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        tgen.read_relation(str(tmp_path / "none.tbl"), device=CPU)


def test_zipf_golden_vs_reference_c():
    """The first draws of the reference's genzipf.c (the golden values
    tests/test_datagen.py pins for the JAX generator)."""
    from avx_sort_merge_joins_tpu_torch.datagen.genzipf import gen_zipf

    golden = {
        (42, 1000, 1.0): [281, 817, 148, 557, 557, 668],
        (7, 500, 0.5): [192, 292, 65, 165, 495, 151],
        (42, 1000, 0.75): [283, 878, 148, 902, 152, 197],
    }
    for (seed, alpha, z), expect in golden.items():
        assert gen_zipf(12, alpha, z, tdg.GlibcRand(seed))[:6].tolist() \
            == expect, (seed, alpha, z)


@pytest.mark.parametrize("n,alphabet,z", [
    (5000, 1000, 1.0),          # numpy draws and alphabet shuffle
    (70_000, 3000, 0.5),        # native draws, numpy shuffle
    (70_000, 100_000, 1.25),    # native draws and shuffle
])
def test_zipf_streams_match_jax(n, alphabet, z):
    from avx_sort_merge_joins_tpu.datagen.genzipf import gen_zipf as jzipf
    from avx_sort_merge_joins_tpu_torch.datagen.genzipf import gen_zipf

    j, t = jdg.GlibcRand(n), tdg.GlibcRand(n)
    np.testing.assert_array_equal(gen_zipf(n, alphabet, z, t),
                                  jzipf(n, alphabet, z, j))
    assert j.rand() == t.rand()  # the same draws consumed


@pytest.mark.parametrize("n,maxid", [(20_000, 5000), (100_000, 70_000)])
def test_zipf_relation_matches(n, maxid):
    _pair(lambda: jdg.create_relation_zipf(n, maxid, 0.9),
          lambda: tdg.create_relation_zipf(n, maxid, 0.9, device=CPU), 77)


@pytest.mark.parametrize("step", [1000, 1 << 26])
def test_device_path_in_steps_and_quarters_matches_jax(monkeypatch, step):
    """The device generation sorts the draws in four quarters of their
    range, its element-wise passes ``GEN_STEP`` at a time: at any step it
    is the JAX package's one stable sort, near the seed's wrap too."""
    monkeypatch.setattr(tgen, "GEN_STEP", step)
    n = 70_001
    for seed, maxid, nthreads in ((2**31 - 101, 333, 7), (5, n, 1)):
        keys, payloads = tgen._device_gen(n, maxid, nthreads, seed, CPU)
        jk, jp = jgen._device_gen(n, maxid, nthreads)(jnp.int32(seed))
        np.testing.assert_array_equal(keys.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(payloads.numpy(), np.asarray(jp))
