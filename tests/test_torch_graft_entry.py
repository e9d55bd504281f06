"""The port's driver entry points (``avx_sort_merge_joins_tpu_torch/
graft_entry.py``) against the JAX ``__graft_entry__.py`` on the CPU: the
same inputs element for element, the flagship count, and the dryrun's
legs on meshes of 2, 4 and 8 shards, each exact (integers: tolerance 0).
The JAX dryrun itself is not run (its Pallas legs in interpret mode take
minutes); its inputs are compared, and every leg's count is held to the
numpy oracle the JAX dryrun uses."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from avx_sort_merge_joins_tpu import datagen as jdatagen
from avx_sort_merge_joins_tpu_torch import graft_entry as tentry
from avx_sort_merge_joins_tpu_torch.kernels import _build
from avx_sort_merge_joins_tpu_torch.parallel import dist_join, dist_mpsm


@pytest.fixture
def no_kernel_build(monkeypatch):
    """Fail on any build or load of the CUDA library."""
    def refuse():
        raise AssertionError("the CUDA library was built or loaded")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def test_entry_inputs_equal_jax_and_build_nothing(no_kernel_build):
    forward, (rk, sk) = tentry.entry(device="cpu")
    _, (jrk, jsk) = jentry.entry()
    assert rk.dtype == sk.dtype == torch.int32
    np.testing.assert_array_equal(rk.numpy(), np.asarray(jrk))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jsk))
    assert sorted(rk.tolist()) == list(range(1, tentry.ENTRY_N + 1))


def test_entry_forward_counts_64k_on_the_cpu(no_kernel_build):
    forward, inputs = tentry.entry(device="cpu")
    out = forward(*inputs)
    assert out.dtype == torch.int64 and out.dim() == 0
    assert int(out) == tentry.ENTRY_N == 65536


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


def test_dryrun_inputs_equal_jax():
    """R, S and payloads of ``__graft_entry__.py:87-92``, and its Zipf S:
    ``create_relation_zipf(8192, 4096, 1.0)`` after
    ``seed_generator(12345)``, element for element."""
    rk, rp, sk, sp, sk_z = tentry.dryrun_inputs()
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(
        rk, rng.permutation(np.arange(1, 4097)).astype(np.int32))
    np.testing.assert_array_equal(sk, rng.integers(1, 4097, 8192)
                                  .astype(np.int32))
    np.testing.assert_array_equal(rp, np.arange(4096, dtype=np.int32))
    np.testing.assert_array_equal(sp, np.arange(8192, dtype=np.int32))
    jdatagen.seed_generator(12345)
    want_z = np.asarray(jdatagen.create_relation_zipf(8192, 4096, 1.0).keys)
    assert sk_z.dtype == np.int32
    np.testing.assert_array_equal(sk_z, want_z[:8192])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_passes_every_leg(n, capsys):
    legs = tentry.dryrun_multichip(n, device="cpu")
    want = ["dist_join", "m-way", "m-pass", "remote-pull", "2-D mesh",
            "mpsm", "materialize", "zipf", "remote-pull dma"]
    if n < 4:
        want.remove("2-D mesh")
    assert list(legs) == want
    rk, _, sk, _, sk_z = tentry.dryrun_inputs()
    from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
    for name, leg in legs.items():
        assert leg["count"] == merge_join_count_numpy(
            rk, sk_z if name == "zipf" else sk), name
        assert leg["launches"] == {}  # the CPU runs the plain versions
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[dryrun_multichip] {n} devices: count="
                           f"{legs['dist_join']['count']} OK "
                           f"({len(want)} legs: ")


def test_dryrun_leg_with_a_wrong_count_names_it(monkeypatch):
    real = dist_mpsm.dist_mpsm_join_count
    monkeypatch.setattr(dist_mpsm, "dist_mpsm_join_count",
                        lambda *a, **k: (real(*a, **k)[0] + 1, 0))
    with pytest.raises(AssertionError, match=r"^mpsm: count \d+ != "
                                             r"expected \d+"):
        tentry.dryrun_multichip(4, device="cpu")


def test_dryrun_leg_with_overflow_names_it(monkeypatch):
    real = dist_join.dist_join_count
    monkeypatch.setattr(dist_join, "dist_join_count",
                        lambda *a, **k: (real(*a, **k)[0], 1))
    with pytest.raises(AssertionError, match=r"^dist_join: bucket overflow "
                                             r"1"):
        tentry.dryrun_multichip(2, device="cpu")


def test_leg_that_launched_no_kernel_fails_on_the_card(monkeypatch):
    """On the card a leg whose kernels did not launch (a plain route)
    fails with its name, though its count is right."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    with pytest.raises(AssertionError, match=r"^m-pass: never launched "
                                             r"\['K1', 'K4', 'K3'\]"):
        tentry._leg("m-pass", lambda: (5, 0), 5, on_card=True)
    assert tentry._leg("dist_join", lambda: (5, 0), 5, on_card=True) == {
        "count": 5, "launches": {}}


def test_main_prints_the_nine_leg_line(capsys):
    assert tentry.main(["8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[entry] 65536 x 65536: count=65536"
    assert out[-1].startswith("[dryrun_multichip] 8 devices: count=8192 OK "
                              "(9 legs: dist_join, m-way, m-pass, "
                              "remote-pull, 2-D mesh, mpsm, materialize, "
                              "zipf, remote-pull dma)")


def test_main_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tentry.main(["2"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_no_jax_import():
    import subprocess
    import sys

    code = ("import sys, avx_sort_merge_joins_tpu_torch.graft_entry as g; "
            "g.dryrun_multichip(2, 'cpu'); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'avx_sort_merge_joins_tpu' or "
            "m.startswith('avx_sort_merge_joins_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)
