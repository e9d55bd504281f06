"""A/B of the caching allocator's ``expandable_segments:True`` against
its default on two cells of the results grid, one fresh process a run.

    python -m avx_sort_merge_joins_tpu_torch.bench.alloc_conf \\
        [KEY ...] [--rounds N]

Each cell (default: ``algo/m-way/128000000/cuda`` and
``scale/m-way/838860800/cuda``) runs in turns, default, expandable,
expandable, default (``--rounds`` times that), each run a new process that
times the cell as the grid does (``scripts/run_results_grid.py``: a
warm-up, 2 untimed calls, 3 timed between CUDA events) with
``PYTORCH_CUDA_ALLOC_CONF`` set to ``expandable_segments:False`` or
``:True`` (so that a default the entry points install does not decide the
arm).  Prints each run's milliseconds and peak device memory, then each
arm's median and the expandable arm's change against the default.  Needs
the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

CELLS = ("algo/m-way/128000000/cuda", "scale/m-way/838860800/cuda")
ARMS = {"default": "expandable_segments:False",
        "expandable": "expandable_segments:True"}


def worker(key: str, out: str) -> None:
    """Run cell ``key`` alone into ``out`` (a new file): every other cell
    its grid would visit is marked done first."""
    import torch

    from ..scripts import rerun_cells as rc
    from ..scripts import run_results_grid as rg

    name, kw = rc.grid_call(key, {"mult32M": int(key.split("/")[2])
                                  // rg.MI32} if key.startswith("scale/")
                            else {"phases_ms": 1})
    g = rg.Grid(out, torch.device("cuda"))
    if name == "algo":
        n = kw["sizes"][0]
        g.done.update(f"algo/{a}/{n}/{m}" for a in ("m-way", "m-pass", "mpsm")
                      for m in ("cuda", "scalar"))
        g.done.add(f"algo/mpsm/{n}/cuda/nchunks4")
        g.done.discard(key)
        kw["phases_from"] = n + 1  # the timed cell alone
    rg.GRIDS[name](g, **kw)


def run(key: str, arm: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "row.jsonl")
        env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=ARMS[arm])
        proc = subprocess.run(
            [sys.executable, "-m", __spec__.name, "--worker", key, out],
            env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{key} {arm}: exit {proc.returncode}\n"
                               f"{proc.stderr[-3000:]}")
        with open(out) as f:
            row = json.loads(f.readline())
    if not row["exact"]:
        raise AssertionError(f"{key} {arm}: not exact")
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog=__spec__.name if __spec__ else None,
                                description=__doc__.splitlines()[0])
    p.add_argument("keys", nargs="*", default=list(CELLS))
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--worker", nargs=2, metavar=("KEY", "OUT"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(*args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("[ERROR] no CUDA device: the A/B times the card",
              file=sys.stderr)
        return 1
    order = ["default", "expandable", "expandable", "default"] * args.rounds
    for key in args.keys:
        ms = {a: [] for a in ARMS}
        for arm in order:
            row = run(key, arm)
            ms[arm].append(row["ms"])
            print(f"[alloc] {key} {arm}: {row['ms']} ms, peak "
                  f"{row.get('peak_gb', 'not recorded')} GB "
                  f"({row['device']})", flush=True)
        med = {a: statistics.median(v) for a, v in ms.items()}
        print(f"[alloc] {key}: median default {med['default']} ms, "
              f"expandable {med['expandable']} ms, change "
              f"{(med['expandable'] / med['default'] - 1) * 100:+.3f}%",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
