"""The 2-way merge facade of the PyTorch port (K6 at fan-in 2, K2 for keys
only, on the CPU path of the wrappers) against the JAX package (Pallas in
interpret mode) and the numpy oracle, on the same seeded inputs.
Tolerance: exact equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avx_sort_merge_joins_tpu.ops import merge as jmg
from avx_sort_merge_joins_tpu_torch.ops import merge as tmg
from avx_sort_merge_joins_tpu_torch.ops import sort as tsort

DOMAIN_MAX = 2**31 - 2


def _run(n, rng, pmax=100):
    """An ascending run of n pairs over the whole key domain, both of its
    ends included."""
    k = rng.integers(-DOMAIN_MAX, DOMAIN_MAX + 1, n).astype(np.int32)
    k[:2] = (-DOMAIN_MAX, DOMAIN_MAX)[:min(n, 2)]
    p = rng.integers(0, pmax, n).astype(np.int32)
    order = np.lexsort((p, k))
    return k[order], p[order]


@pytest.mark.parametrize("na,nb", [(20000, 20000), (16384, 9000), (5, 40000)])
def test_merge_tuples_matches_jax(na, nb):
    rng = np.random.default_rng(na + nb)
    ka, pa = _run(na, rng)
    kb, pb = _run(nb, rng)
    jk, jp = jmg.merge_tuples(jnp.asarray(ka), jnp.asarray(pa),
                              jnp.asarray(kb), jnp.asarray(pb))
    tk, tp = tmg.merge_tuples(*(torch.from_numpy(a)
                                for a in (ka, pa, kb, pb)))
    ek, ep = tmg.merge_numpy(ka, pa, kb, pb)
    assert tk.shape == tp.shape == (na + nb,)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tk.numpy(), ek)
    np.testing.assert_array_equal(tp.numpy(), ep)


@pytest.mark.parametrize("na,nb", [(16384, 16384), (0, 700), (700, 0)])
def test_merge_keys_only_matches_jax(na, nb):
    rng = np.random.default_rng(na + 3 * nb)
    ka, _ = _run(na, rng)
    kb, _ = _run(nb, rng)
    tk, tp = tmg.merge_tuples(torch.from_numpy(ka), None,
                              torch.from_numpy(kb), None)
    assert tp is None
    np.testing.assert_array_equal(tk.numpy(),
                                  np.sort(np.concatenate([ka, kb])))
    if na and nb:
        jk, jp = jmg.merge_tuples(jnp.asarray(ka), None, jnp.asarray(kb),
                                  None)
        assert jp is None
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_merge_tuples_identical_pairs_and_pad_payloads():
    """The same (key, payload) pair in both runs, payloads equal to the
    pad values, and logical lengths below the columns' sizes."""
    ka = np.repeat(np.arange(-3, 4, dtype=np.int32), 300)
    pa = np.tile(np.array([-(2**31), 0, 2**31 - 1], np.int32), 700)
    order = np.lexsort((pa, ka))
    ka, pa = ka[order], pa[order]
    na, nb = 2000, 1500
    tk, tp = tmg.merge_tuples(torch.from_numpy(ka), torch.from_numpy(pa),
                              torch.from_numpy(ka), torch.from_numpy(pa),
                              na, nb)
    ek, ep = tmg.merge_numpy(ka[:na], pa[:na], ka[:nb], pa[:nb])
    np.testing.assert_array_equal(tk.numpy(), ek)
    np.testing.assert_array_equal(tp.numpy(), ep)


def test_scalar_merge_matches_jax():
    rng = np.random.default_rng(5)
    ka, pa = _run(1000, rng, 3)
    kb, pb = _run(2000, rng, 3)
    jk, jp = jmg.scalar_merge_tuples(jnp.asarray(ka), jnp.asarray(pa),
                                     jnp.asarray(kb), jnp.asarray(pb))
    tk, tp = tmg.scalar_merge_tuples(*(torch.from_numpy(a)
                                       for a in (ka, pa, kb, pb)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    ek, ep = jmg.merge_numpy(ka, pa, kb, pb)
    np.testing.assert_array_equal(tk.numpy(), ek)
    np.testing.assert_array_equal(tp.numpy(), ep)


@pytest.mark.parametrize("pa,pb", [(None, None), (0, 1), ("col", "col")])
def test_two_run_layout_pads_sort_last(pa, pb):
    ka = torch.arange(5, dtype=torch.int32)
    kb = torch.arange(40, dtype=torch.int32)
    columns = pa == "col"
    if columns:
        pa, pb = ka + 100, kb + 200
    keys, pays, (nruns, total, span) = tsort.two_run_layout(ka, kb, 5, 40,
                                                            pa, pb)
    assert (nruns, total, span) == (2, 80, 40)
    assert bool((keys[5:40] == 2**31 - 1).all())
    assert torch.equal(keys[40:], kb)
    if pa is None:
        assert pays is None
    else:
        assert bool((pays[5:40] == 2**31 - 1).all())
        assert int(pays[0]) == (100 if columns else 0)
        assert int(pays[79]) == (239 if columns else 1)
