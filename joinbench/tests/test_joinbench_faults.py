"""A run with the timed path broken underneath comes out not correct: the
harness's whole run on the CPU (its look for a card skipped by
``--device cpu``), once for each fault a cell can have."""

import io
import json

import pytest
import torch

from avx_sort_merge_joins_tpu_torch.ops import materialize, mergejoin
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops
from avx_sort_merge_joins_tpu_torch.parallel.mesh import Mesh
from joinbench import run, spec

ROOT = spec.default_root()
COUNT_CELLS = ["wlB_128M.mway_count", "wlA_1600M.mway_uniform",
               "wlA_1600M.mway_zipf1", "wlB_128M.mpass_count"]
ROW_CELLS = ["wlB_128M.mway_materialize"]
SHARDED = ["wlA_1600M.mway_uniform", "wlA_1600M.mway_zipf1"]


def _unsorted_blocks(keys, n, block=16384):
    """K1 returning its state unchanged: the blocks, padded, not sorted."""
    return sort_ops._padded(keys, n, max(1, -(-n // block)) * block)


def _unsorted_pair_blocks(keys, payloads, n, block=16384, descending=False):
    cap = max(1, -(-n // block)) * block
    return (sort_ops._padded(keys, n, cap), sort_ops._padded(payloads, n,
                                                             cap))


def _merge_unchanged(keys, n, level, payloads=None, tile=None):
    """A K2/K6 merge level returning its state unchanged."""
    return keys if payloads is None else (keys, payloads)


def _merge_pass_unchanged(keys, payloads, uniform_lens, descending=False):
    """A K4 pass returning its state unchanged."""
    return keys, payloads


def _walk_count(rk, sk, nR, nS):
    """K3's count as K3 reads its input: one merge walk over two ascending
    columns (the plain version on the CPU searches instead, and finds the
    matches of unsorted columns too)."""
    r, s = rk[:nR].tolist(), sk[:nS].tolist()
    i = j = 0
    count = 0
    while i < nR and j < nS:
        if r[i] < s[j]:
            i += 1
        elif r[i] > s[j]:
            j += 1
        else:
            key, i0, j0 = r[i], i, j
            while i < nR and r[i] == key:
                i += 1
            while j < nS and s[j] == key:
                j += 1
            count += (i - i0) * (j - j0)
    return torch.tensor(count, dtype=torch.int64)


def sort_unchanged(mp):
    """The sort's steps return their state unchanged: K1/K5, the uniform
    K2/K6 merge levels and K4's passes, with K3 counting as it does on the
    card.  (The plain merge level and pass on the CPU sort whole groups,
    so K1 alone unchanged would not show there.)"""
    mp.setattr(sort_ops, "sort_blocks", _unsorted_blocks)
    mp.setattr(sort_ops, "sort_blocks_pairs", _unsorted_pair_blocks)
    mp.setattr(mw, "merge_level", _merge_unchanged)
    mp.setattr(sort_ops, "merge_pass", _merge_pass_unchanged)
    mp.setattr(mergejoin, "merge_join_count_fused", _walk_count)


def merge_passes_unchanged(mp):
    """K4's pairwise passes return their input unchanged, the blocks
    sorted by K1 and counted by K3 as on the card: m-pass's own merge."""
    mp.setattr(sort_ops, "merge_pass", _merge_pass_unchanged)
    mp.setattr(mergejoin, "merge_join_count_fused", _walk_count)


def half_of_s(mp):
    """Half of the batch left out: every count and match over S's first
    half only."""
    count, matches = mergejoin.merge_join_count_fused, \
        materialize.materialize_matches
    mp.setattr(mergejoin, "merge_join_count_fused",
               lambda rk, sk, nR, nS: count(rk, sk, nR, nS // 2))
    mp.setattr(materialize, "materialize_matches",
               lambda rk, nR, sk, sp, nS: matches(rk, nR, sk, sp, nS // 2))


def exchange_skipped(mp):
    """The exchange between shards left out: each shard keeps its own
    buckets."""
    mp.setattr(Mesh, "all_to_all", lambda self, x, axis=None: x.clone())
    mp.setattr(Mesh, "all_to_all_row",
               lambda self, x, d: x[d].clone())


def answer_altered(mp):
    """An answer altered where it is produced: K3's count one too many, or
    one matched row's payload changed."""
    count, matches = mergejoin.merge_join_count_fused, \
        materialize.materialize_matches

    def altered(*a):
        ok, op, om, nm = matches(*a)
        op = op.clone()
        op[nm // 2] += 1
        return ok, op, om, nm

    mp.setattr(mergejoin, "merge_join_count_fused",
               lambda *a: count(*a) + 1)
    mp.setattr(materialize, "materialize_matches", altered)


CASES = ([(f, c) for f in (sort_unchanged, half_of_s, answer_altered)
          for c in COUNT_CELLS + ROW_CELLS]
         + [(exchange_skipped, c) for c in SHARDED]
         + [(merge_passes_unchanged, "wlB_128M.mpass_count")])


def _run(cell, seed="4000000007"):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", cell, "--seed", seed, "--seconds", "0.2",
                   "--device", "cpu", "--tuples", "48000"], out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.fixture(autouse=True)
def _no_jax_gate(monkeypatch):
    # other test files of a session may load JAX; these tests judge correct
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])


@pytest.mark.parametrize("cell", COUNT_CELLS + ROW_CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] is True and res["failed"] == 0


@pytest.mark.parametrize("fault,cell", CASES,
                         ids=[f"{f.__name__}-{c}" for f, c in CASES])
def test_fault_is_not_correct(fault, cell, monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_unsorted_blocks_really_are_unsorted():
    keys = torch.randperm(40000).int()
    assert not torch.equal(_unsorted_blocks(keys, 40000)[:40000],
                           sort_ops.sort_blocks(keys, 40000)[:40000])


def test_merge_pass_unchanged_leaves_runs_unmerged():
    keys = sort_ops.sort_blocks(torch.randperm(40000).int(), 40000)
    level = sort_ops.pair_levels(40000, 16384)[0]
    out = _merge_pass_unchanged(keys, None, (level[0], 40000, level[1]))[0]
    assert torch.equal(out, keys)
    assert not torch.equal(out, sort_ops.merge_pass(
        keys, None, (level[0], 40000, level[1]))[0])


def test_walk_count_is_the_count_on_sorted_columns():
    r = torch.tensor([1, 2, 2, 5, 9], dtype=torch.int32)
    s = torch.tensor([2, 2, 3, 5, 5, 10], dtype=torch.int32)
    assert int(_walk_count(r, s, 5, 6)) == int(
        mergejoin.merge_join_count_fused(r, s, 5, 6)) == 6
