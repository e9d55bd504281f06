"""The port's mesh of one device a shard (``parallel/mesh.py``'s
``make_mesh(n, devices=...)`` and ``mesh_from_mapping_file``) on the CPU,
where the device list repeats the CPU: the mapping file against the JAX
package's, each collective against the one-device mesh's on the same
seeded data, every distributed route against the one-device mesh and the
numpy oracle, and ``--mapping-file`` through the CLI against the JAX CLI.
Integers throughout: tolerance 0."""

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu import cli as jcli
from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.parallel import mesh as jmesh
from avx_sort_merge_joins_tpu_torch import cli as tcli
from avx_sort_merge_joins_tpu_torch import graft_entry
from avx_sort_merge_joins_tpu_torch.parallel import (dist_join,
                                                     dist_materialize,
                                                     dist_mpass, dist_mpsm,
                                                     dist_mway)
from avx_sort_merge_joins_tpu_torch.parallel import exchange as tex
from avx_sort_merge_joins_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")
CARDS = [CPU] * 8


@pytest.fixture(autouse=True)
def no_installed_mesh(monkeypatch):
    """Both packages keep the installed mapping mesh and host granularity
    as module state: every test starts without them and restores them."""
    for mod in (jmesh, tmesh):
        monkeypatch.setattr(mod, "HOST_GRANULARITY", None)
        monkeypatch.setattr(mod, "DEFAULT_MESH", None)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _file(tmp_path, text, name="mapping.txt"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


# ------------------------------------------------------------ mapping --

@pytest.mark.parametrize("text", ["8 0 1 2 3 4 5 6 7 2\n",
                                  "8 7 6 5 4 3 2 1 0\n"])
def test_mapping_file_equals_jax(tmp_path, text):
    """The same file through both packages: the shard count, the host
    granularity (4 from the trailing host count; without it the shards of
    one process, 8) and the RING order element for element."""
    path = _file(tmp_path, text)
    j = jmesh.mesh_from_mapping_file(path)
    t = tmesh.mesh_from_mapping_file(path, "cpu")
    assert t.n == np.asarray(j.devices).size == 8
    assert t.per_shard and t.devices == (CPU,) * 8
    assert tmesh.chips_per_host_of(t) == jmesh.chips_per_host_of(j) == \
        (4 if text.endswith("2\n") else 8)
    want = jmesh.shuffle_order("RING", 8, jmesh.chips_per_host_of(j))
    got = tmesh.shuffle_order("RING", 8, tmesh.chips_per_host_of(t))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_mapping_file_refuses_short_files_and_absent_cards(tmp_path,
                                                           monkeypatch):
    with pytest.raises(ValueError, match="NDEV 8 but 3 device ids"):
        tmesh.mesh_from_mapping_file(_file(tmp_path, "8 0 1 2"), "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=r"device ids \[2\] past the 2"):
        tmesh.mesh_from_mapping_file(_file(tmp_path, "4 0 1 2 0"), "cuda")
    mesh = tmesh.mesh_from_mapping_file(_file(tmp_path, "4 1 0 1 0"), "cuda")
    assert [d.index for d in mesh.devices] == [1, 0, 1, 0]
    assert tmesh.HOST_GRANULARITY is None  # no trailing host count


def test_make_mesh_takes_the_installed_mesh(tmp_path, monkeypatch):
    """``make_mesh(n)`` without a device takes the first n of the
    installed mesh's devices; more than it has raises (the JAX mesh would
    shrink); a named device still builds the one-device mesh."""
    monkeypatch.setattr(tmesh, "DEFAULT_MESH", tmesh.mesh_from_mapping_file(
        _file(tmp_path, "4 0 0 0 0"), "cpu"))
    mesh = tmesh.make_mesh(2)
    assert mesh.n == 2 and mesh.devices == (CPU, CPU)
    assert tmesh.make_mesh2d(2, 2).devices == (CPU,) * 4
    with pytest.raises(ValueError, match="8 shards, 4 devices"):
        tmesh.make_mesh(8)
    assert not tmesh.make_mesh(8, CPU).per_shard
    with pytest.raises(ValueError, match="3 shards, 2 devices"):
        tmesh.make_mesh(3, devices=[CPU, CPU])


# -------------------------------------------------------- collectives --

def _meshes(two_d):
    if two_d:
        return tmesh.make_mesh2d(2, 4, CPU), tmesh.make_mesh2d(
            2, 4, devices=CARDS)
    return tmesh.make_mesh(8, CPU), tmesh.make_mesh(8, devices=CARDS)


def _rows(x):
    return [r.clone() for r in x]


@pytest.mark.parametrize("two_d", [False, True])
def test_collectives_equal_the_one_device_mesh(two_d):
    """Each collective's per-shard result is row ``me`` of the one-device
    mesh's on the same seeded data: all_to_all over the flat mesh and each
    axis, all_to_all_row, all_gather, ppermute over the flat mesh and each
    axis, and the two-stage exchange with and without a host schedule."""
    one, cards = _meshes(two_d)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-9, 9, (8, 8 * 24)).astype(np.int32))
    xs = _rows(x)

    def same(got, want):
        assert isinstance(got, list) and len(got) == 8
        for me in range(8):
            assert torch.equal(got[me], want[me]), me

    axes = [None] + ([tmesh.AXIS, tmesh.HOST_AXIS] if two_d else [])
    for axis in axes:
        same(cards.all_to_all(xs, axis), one.all_to_all(x, axis))
    for d in range(8):
        assert torch.equal(cards.all_to_all_row(xs, d),
                           one.all_to_all_row(x, d))
    gathered = cards.all_gather(xs)
    for me in range(8):
        assert torch.equal(gathered[me], one.all_gather(x))
    perms = [(None, [(s, (s + 3) % 8) for s in range(8)]),
             (None, [(0, 5), (5, 2)])]
    if two_d:
        perms += [(tmesh.AXIS, [(c, (c + 1) % 4) for c in range(4)]),
                  (tmesh.HOST_AXIS, [(0, 1)])]
    for axis, perm in perms:
        same(cards.ppermute(xs, perm, axis), one.ppermute(x, perm, axis))
    if two_d:
        for sched in (None, [0, 1]):
            same(tex.exchange_hier(cards, xs, 24, sched),
                 tex.exchange_hier(one, x, 24, sched))


def test_layout_helpers_equal_the_stack():
    one, cards = _meshes(False)
    x = torch.arange(8 * 32, dtype=torch.int32).reshape(8, 32)
    xs = _rows(x)
    for off in (0, 3, -2):
        got = cards.rotated_blocks(xs, 4, off)
        want = one.rotated_blocks(x, 4, off)
        assert all(torch.equal(got[me], want[me]) for me in range(8))
        out1, outc = torch.zeros_like(x), [torch.zeros_like(r) for r in xs]
        one.put_rotated_blocks(out1, want, 4, off)
        cards.put_rotated_blocks(outc, got, 4, off)
        assert all(torch.equal(outc[me], out1[me]) for me in range(8))
    assert cards.tolist(xs) == one.tolist(x)
    with pytest.raises(ValueError, match="shard 3 on"):
        bad = list(xs)
        bad[3] = torch.zeros(32, dtype=torch.int32, device="meta")
        cards.all_gather(bad)
    with pytest.raises(ValueError, match=r"int32\[32\] on 8 shards"):
        cards.check_rows(xs[:7], "x", 32)


# ------------------------------------------------------------- routes --

def _workload(kind):
    """``uniform``; ``tiny``: 9 R and 5 S keys over 8 shards, so shards of
    2, 1 and 0 live keys; ``hot``: one key with 2^15 copies in R and 2^14
    in S, cntR * cntS = 2^29 on one shard."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "uniform":
        rk = rng.permutation(np.arange(1, 6001)).astype(np.int32)
        sk = rng.integers(1, 6001, 7003).astype(np.int32)
    elif kind == "tiny":
        rk = np.array([5, 1, 9, 3, 7, 2, 8, 6, 4], np.int32)
        sk = np.array([9, 9, 4, 100, 1], np.int32)
    else:
        rk = np.concatenate([np.full(1 << 15, 7),
                             rng.integers(8, 900, 301)]).astype(np.int32)
        sk = np.concatenate([np.full(1 << 14, 7),
                             rng.integers(1, 900, 199)]).astype(np.int32)
        rk, sk = rng.permutation(rk), rng.permutation(sk)
    return rk, sk


def _count(route, rk, sk, mesh):
    """(count, overflow) of ``route`` on ``mesh``; the materializing join's
    rows as a sorted multiset in place of the count."""
    nr, ns = len(rk), len(sk)
    if route == "dist_join":
        return dist_join.dist_join_count(rk, np.zeros_like(rk), sk,
                                         np.zeros_like(sk), nr, ns, mesh,
                                         slack=16.0)
    if route == "m-pass":
        return dist_mpass.dist_mpass_join_count(rk, sk, nr, ns, mesh)
    if route == "m-pass overlap":
        return dist_mpass.dist_mpass_join_count(rk, sk, nr, ns, mesh,
                                                overlap=True)
    if route == "mpsm":
        return dist_mpsm.dist_mpsm_join_count(rk, sk, nr, ns, mesh)
    if route == "materialize":
        sp = np.arange(ns, dtype=np.int32)
        ok, op, cnt, ov = dist_materialize.dist_join_materialize(
            rk, np.zeros_like(rk), sk, sp, nr, ns, mesh)
        rows = sorted(zip(ok.tolist(), op.tolist()))
        assert len(rows) == cnt
        return rows, ov
    kw = {"bulk": {}, "RING": {"numa_strategy": "RING"},
          "RANDOM": {"numa_strategy": "RANDOM"}, "overlap": {"overlap": True},
          "emulate": {"remote_pull": "emulate"},
          "dma": {"remote_pull": "dma"}, "2-D": {}}[route]
    return dist_mway.dist_mway_join_count(rk, sk, nr, ns, mesh, **kw)


ROUTES = ["bulk", "RING", "RANDOM", "2-D", "overlap", "emulate", "dma",
          "dist_join", "m-pass", "m-pass overlap", "mpsm", "materialize"]
# the materializing join on the hot key would emit 2^29 rows
CASES = [(r, k) for r in ROUTES for k in ("uniform", "tiny", "hot")
         if (r, k) != ("materialize", "hot")]


@pytest.mark.parametrize("route,kind", CASES)
def test_route_on_a_mesh_of_devices(route, kind):
    """Every distributed route on ``make_mesh(8, devices=[cpu] * 8)`` (a 2 x
    4 mesh for "2-D"): the count equals the one-device mesh's and numpy's,
    overflow 0, exactly in int64 on the hot key; the materializing join's
    rows equal the one-device mesh's as a multiset and number the count
    (not on the hot key: 2^29 rows)."""
    rk, sk = _workload(kind)
    one, cards = _meshes(route == "2-D")
    got, ov = _count(route, rk, sk, cards)
    want, ov1 = _count(route, rk, sk, one)
    assert ov == ov1 == 0
    assert got == want
    n = len(got) if route == "materialize" else got
    assert n == merge_join_count_numpy(rk, sk)
    if kind == "hot":
        assert n >= 1 << 29


def test_dryrun_on_a_mesh_of_devices(capsys):
    """``dryrun_multichip(8, devices=...)``: all nine legs exact, each
    leg's count the one-device dryrun's."""
    legs = graft_entry.dryrun_multichip(8, devices=CARDS)
    one = graft_entry.dryrun_multichip(8, "cpu")
    assert list(legs) == list(one) and len(legs) == 9
    assert {k: v["count"] for k, v in legs.items()} == \
        {k: v["count"] for k, v in one.items()}
    assert "9 legs" in capsys.readouterr().out


# ---------------------------------------------------------------- CLI --

def test_cli_mapping_file_ring_equals_the_jax_cli(tmp_path, capsys):
    """``-n 8 -S RING --mapping-file F`` (8 devices over 2 hosts: RING
    strides by 4) prints the JAX CLI's ``Results =`` for the same file and
    sizes (the JAX CLI on its 8 CPU devices, its torch.sort-free baseline
    route), and the CLI leaves no mesh installed."""
    path = _file(tmp_path, "8 0 1 2 3 4 5 6 7 2\n")
    argv = ["-a", "m-way", "-n", "8", "-S", "RING", "-r", "20000", "-s",
            "30000", "-x", "3", "-y", "4", "--mapping-file", path]
    assert jcli.main([*argv, "--scalarsort", "--scalarmerge"]) == 0
    want = capsys.readouterr().out.split("Results = ")[1].split()[0]
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.split("Results = ")[1].split()[0]
    assert got == want == "30000"
    assert tmesh.DEFAULT_MESH is None and tmesh.HOST_GRANULARITY is None


def test_cli_mapping_file_id_past_the_cards_exits_2(tmp_path, capsys,
                                                    monkeypatch):
    """On the card an id at or past ``torch.cuda.device_count()`` exits 2
    with the reason and no result (one card, here stood in for)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    path = _file(tmp_path, "2 0 1\n")
    assert tcli.main(["-n", "2", "-r", "100", "-s", "100",
                      "--mapping-file", path]) == 2
    cap = capsys.readouterr()
    assert "Results" not in cap.out
    assert "device ids [1] past the 1 CUDA devices" in cap.err
