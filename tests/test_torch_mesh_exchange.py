"""The port's mesh and exchange (``parallel/mesh.py``,
``parallel/exchange.py``) against the JAX package's on the same seeded
inputs: integers, tolerance 0.  The JAX collectives run on its 8-device
CPU mesh; the port's on a mesh of 8 shards on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from avx_sort_merge_joins_tpu.parallel import exchange as jex
from avx_sort_merge_joins_tpu.parallel import mesh as jmesh
from avx_sort_merge_joins_tpu_torch.parallel import exchange as tex
from avx_sort_merge_joins_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_installed_granularity(monkeypatch):
    """Both packages keep the host granularity as module state that an
    earlier test may have installed: start every test without it."""
    monkeypatch.setattr(jmesh, "HOST_GRANULARITY", None)
    monkeypatch.setattr(tmesh, "HOST_GRANULARITY", None)


@pytest.mark.parametrize("strategy", ["NEXT", "RING", "RANDOM"])
@pytest.mark.parametrize("chips_per_host", [1, 2, 3, 4, 8])
def test_shuffle_order_equals_jax(strategy, chips_per_host):
    for n in range(1, 17):
        want = jmesh.shuffle_order(strategy, n, chips_per_host)
        got = tmesh.shuffle_order(strategy, n, chips_per_host)
        assert got.dtype == want.dtype and np.array_equal(got, want), n
        assert sorted(got.tolist()) == list(range(n))
    with pytest.raises(ValueError, match="unknown shuffle strategy"):
        tmesh.shuffle_order("SIDEWAYS", 4)


def test_mesh_topology_equals_jax():
    for n in (1, 3, 8):
        j, t = jmesh.make_mesh(n), tmesh.make_mesh(n, CPU)
        assert (tmesh.is_2d(t), tmesh.flat_axes(t), tmesh.host_shape(t),
                tmesh.chips_per_host_of(t)) == (
            jmesh.is_2d(j), jmesh.flat_axes(j), jmesh.host_shape(j),
            jmesh.chips_per_host_of(j))
    j, t = jmesh.make_mesh2d(2, 4), tmesh.make_mesh2d(2, 4, CPU)
    assert t.n == 8 and tmesh.host_shape(t) == (j.shape["host"],
                                                 j.shape["chips"])
    assert (tmesh.is_2d(t), tmesh.flat_axes(t), tmesh.host_shape(t),
            tmesh.chips_per_host_of(t)) == (
        jmesh.is_2d(j), jmesh.flat_axes(j), jmesh.host_shape(j),
        jmesh.chips_per_host_of(j))
    # make_mesh(chips_per_host=) installs the granularity in both packages
    jmesh.make_mesh(8, chips_per_host=2)
    tmesh.make_mesh(8, CPU, chips_per_host=2)
    assert tmesh.chips_per_host_of(tmesh.make_mesh(8, CPU)) == \
        jmesh.chips_per_host_of(jmesh.make_mesh(8)) == 2


def test_mesh_always_has_n_shards():
    """The JAX make_mesh(n) takes the first n of the devices it finds
    (8 here), so asking for 16 gives 8; the port's mesh has 16."""
    assert np.asarray(jmesh.make_mesh(16).devices).size == 8
    assert tmesh.make_mesh(16, CPU).n == 16
    with pytest.raises(ValueError):
        tmesh.make_mesh(0, CPU)


def test_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh2d(2, 4)


@pytest.mark.parametrize("n,shard,n_chips", [
    (0, 1, 8), (5, 1, 8), (20_000, 2_500, 8), (20_003, 2_501, 8),
    (12_001, 4_001, 3), (7, 2, 6)])
def test_valid_counts_equal_jax(n, shard, n_chips):
    got = tex.valid_counts(n, shard, n_chips)
    want = jex.valid_counts(n, shard, n_chips)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shard,n_chips,slack,align", [
    (1, 8, 2.0, 16384), (16_000_000, 8, 2.0, 16384),
    (32_000_000, 4, 2.0, 16384), (2_501, 8, 3.0, 128),
    (40_000, 8, 16.0, 16384), (5_000, 6, 2.0, 1024)])
def test_bucket_cap_equals_jax(shard, n_chips, slack, align):
    assert tex.bucket_cap(shard, n_chips, slack, align) == \
        jex.bucket_cap(shard, n_chips, slack, align)


@pytest.mark.parametrize("lo,hi", [(1, 20_000), (-(2**31) + 2, 2**31 - 2),
                                   (-(2**31) + 2, 5), (7, 7)],
                         ids=["narrow", "full_range", "negative", "one_key"])
@pytest.mark.parametrize("n_buckets", [3, 8, 16])
def test_dest_of_keys_equals_jax(lo, hi, n_buckets):
    rng = np.random.default_rng(n_buckets)
    keys = rng.integers(lo, hi + 1, 5000, dtype=np.int64).astype(np.int32)
    keys[:2] = [lo, hi]
    want = np.asarray(jex.dest_of_keys(jnp.asarray(keys), n_buckets,
                                       jnp.int32(lo), jnp.int32(hi)))
    got = tex.dest_of_keys(torch.from_numpy(keys), n_buckets,
                           torch.tensor(lo, dtype=torch.int32),
                           torch.tensor(hi, dtype=torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_valid,cap", [(3000, 1024), (3000, 256),
                                         (0, 128), (2999, 4096)],
                         ids=["fits", "overflows", "empty", "ragged"])
def test_bucketize_by_equals_jax(n_valid, cap):
    rng = np.random.default_rng(cap + n_valid)
    keys = rng.integers(-500, 500, 3000).astype(np.int32)
    pays = np.arange(3000, dtype=np.int32)
    dest = rng.integers(0, 8, 3000).astype(np.int32)
    want = jex.bucketize_by(jnp.asarray(dest), jnp.asarray(keys),
                            jnp.asarray(pays), jnp.int32(n_valid), 8, cap,
                            jex.S_PAD_KEY)
    got = tex.bucketize_by(torch.from_numpy(dest), torch.from_numpy(keys),
                           torch.from_numpy(pays), n_valid, 8, cap,
                           tex.S_PAD_KEY)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pad_column_equals_jax():
    x = np.arange(10, dtype=np.int32)
    for total, fill in ((16, 2**31 - 1), (10, 0), (12, -(2**31))):
        np.testing.assert_array_equal(
            tex.pad_column(x, total, fill, device=CPU).numpy(),
            np.asarray(jex.pad_column(x, total, fill)))


def _jax_exchanges(b):
    """JAX's flat all_to_all and two-stage exchange of the (8, 8*cap)
    bucket stack on its 8-device CPU mesh and on its 2 x 4 mesh."""
    cap = b.shape[1] // 8
    flat = jmesh.make_mesh(8)
    f = jax.jit(shard_map(
        lambda x: jax.lax.all_to_all(x[0], jmesh.AXIS, 0, 0,
                                     tiled=True)[None],
        mesh=flat, in_specs=P(jmesh.AXIS), out_specs=P(jmesh.AXIS)))
    m2 = jmesh.make_mesh2d(2, 4)
    spec = jmesh.flat_spec(m2)
    hier = {}
    for sched in (None, (1, 0)):
        hier[sched] = jax.jit(shard_map(
            lambda x, s=sched: jex.exchange_hier(
                x[0], cap, 2, 4, jmesh.HOST_AXIS, jmesh.AXIS,
                host_schedule=s)[None],
            mesh=m2, in_specs=spec, out_specs=spec))
    return (np.asarray(f(jnp.asarray(b))),
            {s: np.asarray(fn(jnp.asarray(b))) for s, fn in hier.items()})


def test_exchanges_equal_jax():
    """The port's all_to_all, its permute-round form and the two-stage
    exchange on a 2 x 4 mesh (one all-to-all or rounds at the host tier)
    all give JAX's flat all_to_all layout bit for bit."""
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as tdm

    cap = 5
    b = np.random.default_rng(3).integers(0, 10**6, (8, 8 * cap)) \
        .astype(np.int32)
    want, want_hier = _jax_exchanges(b)
    for sched in want_hier.values():
        np.testing.assert_array_equal(sched, want)
    flat, m2 = tmesh.make_mesh(8, CPU), tmesh.make_mesh2d(2, 4, CPU)
    tb = torch.from_numpy(b)
    np.testing.assert_array_equal(flat.all_to_all(tb).numpy(), want)
    for order in ([0, 1, 2, 3, 4, 5, 6, 7], [3, 0, 7, 1, 6, 2, 5, 4]):
        np.testing.assert_array_equal(
            tdm._exchange(flat, tb, cap, order).numpy(), want)
    for sched in (None, [1, 0], [0, 1]):
        np.testing.assert_array_equal(
            tex.exchange_hier(m2, tb, cap, sched).numpy(), want)
    np.testing.assert_array_equal(
        flat.all_gather(tb[:, :3]).numpy(), b[:, :3].reshape(-1))


def test_all_to_all_row_is_one_members_share_of_jax():
    """``all_to_all_row(x, d)``, the bulk exchange one landing at a time,
    is row d of JAX's flat all_to_all layout, contiguous."""
    cap = 5
    b = np.random.default_rng(4).integers(0, 10**6, (8, 8 * cap)) \
        .astype(np.int32)
    want, _ = _jax_exchanges(b)
    flat = tmesh.make_mesh(8, CPU)
    for d in range(8):
        got = flat.all_to_all_row(torch.from_numpy(b), d)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want[d])


def test_all_to_all_returns_a_contiguous_stack():
    """One element a piece (the bucket counts): the exchanged stack is a
    fresh contiguous tensor, whose rows a kernel can read as flat
    vectors."""
    counts = torch.arange(64, dtype=torch.int32).reshape(8, 8)
    for mesh in (tmesh.make_mesh(8, CPU), tmesh.make_mesh2d(2, 4, CPU)):
        got = mesh.all_to_all(counts)
        assert got.is_contiguous() and got[3].is_contiguous()
        np.testing.assert_array_equal(got.numpy(), counts.numpy().T)


def test_collectives_check_the_stack():
    mesh = tmesh.make_mesh(4, CPU)
    with pytest.raises(ValueError, match="leading axis"):
        mesh.all_to_all(torch.zeros(3, 12, dtype=torch.int32))
    got = mesh.ppermute(torch.arange(4)[:, None] + 1, [(0, 2), (2, 0)])
    assert got.flatten().tolist() == [3, 0, 1, 0]
