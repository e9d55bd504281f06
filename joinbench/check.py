"""The comparison that decides ``correct``: every answer of the window
against the plain reference (``reference.py``), on the same relations.

Numbers compared, each with its limit (all exact, so every limit is 0):

* ``count_gap_max``: the largest |program count - reference count| over
  the window's joins;
* ``overflow_max``: the largest bucket overflow a join returned (entries
  that report one);
* ``sample_rows_wrong``: over every join of the window, the rows at the
  sampled positions that differ from the reference's row there (row
  answers; the positions are drawn from the seed);
* ``rows_wrong_last``: the rows of the window's last join that differ
  from the reference's, every row compared, plus the difference in
  length (row answers).

A join is failed when its count, its overflow or its sampled rows are
wrong.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference
from .gen import stream_seed

LIMITS = {"count_gap_max": 0, "overflow_max": 0, "sample_rows_wrong": 0,
          "rows_wrong_last": 0}
SAMPLE_ROWS = 4096
STREAM_SAMPLE = 5  # the sample's stream tag, apart from gen.py's


def sample_positions(n_s: int, seed: int, device) -> torch.Tensor:
    """The row positions each join's answer is read at: ``SAMPLE_ROWS``
    draws in [0, |S|) from the run's seed (the matched rows of a pk-fk
    join number |S|)."""
    rng = np.random.default_rng(stream_seed(seed, STREAM_SAMPLE, 2))
    return torch.from_numpy(rng.integers(0, n_s, SAMPLE_ROWS)).to(device)


def read_rows(rows, positions: torch.Tensor) -> dict:
    """What the host reads of a row answer: its length and its packed rows
    at ``positions`` (clamped into the answer; the length tells which
    positions it holds)."""
    keys, payloads = rows
    n = int(keys.numel())
    if n == 0:
        return {"n": 0, "sample": np.zeros(positions.numel(), np.int64)}
    at = positions.clamp(max=n - 1)
    return {"n": n, "sample": reference.pack(keys[at], payloads[at]).cpu()
            .numpy()}


def compare(rel, answers: list, last_rows=None, positions=None):
    """``(checks, failed)``: each compared number with its limit, and how
    many joins failed.  ``answers`` are the host reads of each join,
    ``{"count", ["overflow"], ["rows"]}``; ``last_rows`` the last join's
    rows on the device, for row answers."""
    failed = np.zeros(len(answers), dtype=bool)
    checks = {}
    rowed = last_rows is not None
    if rowed:
        ref = reference.rows(rel.r_keys, rel.s_keys, rel.s_payloads)
        ref_count = int(ref.numel())
    else:
        ref_count = reference.count(rel.r_keys, rel.s_keys)
    gaps = np.array([abs(int(a["count"]) - ref_count) for a in answers])
    failed |= gaps != 0
    checks["count_gap_max"] = int(gaps.max(initial=0))
    if any("overflow" in a for a in answers):
        ov = np.array([int(a.get("overflow", 0)) for a in answers])
        failed |= ov != 0
        checks["overflow_max"] = int(ov.max(initial=0))
    if rowed:
        pos = positions.cpu().numpy()
        held = pos < ref_count
        want = np.zeros(pos.size, np.int64)
        want[held] = ref[positions[torch.from_numpy(held).to(
            positions.device)]].cpu().numpy()
        wrong = []
        for a in answers:
            got = a["rows"]
            inside = pos < got["n"]
            bad = (inside != held) | (inside & held & (got["sample"] != want))
            wrong.append(int(bad.sum()))
        wrong = np.array(wrong)
        failed |= wrong != 0
        checks["sample_rows_wrong"] = int(wrong.sum())
        got = reference.pack(*last_rows)
        common = min(got.numel(), ref.numel())
        checks["rows_wrong_last"] = (
            int((got[:common] != ref[:common]).sum())
            + abs(got.numel() - ref.numel()))
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in checks.items()}, \
        int(failed.sum())


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
