"""Re-run named cells of the port's results grid, e.g. after a model change
(counterpart of ``scripts/rerun_cells.py``).

    python -m avx_sort_merge_joins_tpu_torch.scripts.rerun_cells \\
        KEY [KEY ...] [--device cpu]

Each key must name a row already in ``SMJ_GRID_OUT`` (default
``results_grid_torch.jsonl`` at the repo root); an unknown key exits 2 and
runs nothing.  The keys' done-marks are dropped and each key's grid runs
again at that cell's own size (``run_results_grid.GRIDS``), so every other
cell it visits skips as done.  The new row is appended: the renderer keeps
the last row of each key (``make_results_md.load``), and the superseded
row stays in the file as the record of the A/B.  The JAX script's compile
cache has no counterpart here: PyTorch runs eagerly and the kernels are
built once a process.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..bench import common
from . import make_results_md as mr
from . import run_results_grid as rg


def grid_call(key: str, old: dict) -> tuple[str, dict]:
    """The grid function and the arguments that visit cell ``key`` (its
    last row ``old``) at its own size.  Raises ``ValueError`` on a key no
    grid makes."""
    parts = key.split("/")
    try:
        name = parts[0]
        if name == "algo":
            n = int(parts[2])
            phased = "phases_ms" in old or key.endswith("/nchunks4")
            # the phase columns and the nchunks=4 row as the row was made
            return name, {"sizes": (n,),
                          "phases_from": n if phased else n + 1}
        if name == "key8b":
            return name, {"sizes": (int(parts[2]),)}
        if name == "zipf":
            return name, {"n": int(parts[2]),
                          "zs": (float(parts[3].removeprefix("z")),)}
        if name == "card":
            nR, nS = map(int, parts[2].split("x"))
            return name, {"nR": nR, "ratios": (nS // nR,)}
        if name == "scale":
            n, m = int(parts[2]), int(old.get("mult32M", 1))
            return name, {"mults": (m,), "base": n // m}
    except (IndexError, ValueError) as e:
        raise ValueError(f"{key}: not a grid cell key ({e})") from None
    raise ValueError(f"{key}: no grid {parts[0]!r} (of {list(rg.GRIDS)})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="avx_sort_merge_joins_tpu_torch.scripts.rerun_cells",
        description="re-run named cells of the port's results grid")
    p.add_argument("keys", nargs="+", metavar="KEY",
                   help="grid-cell keys, e.g. algo/m-way/128000000/cuda")
    common.add_device_arg(p)
    args = p.parse_args(argv)
    out = os.environ.get("SMJ_GRID_OUT", rg.DEFAULT_OUT)
    rows = mr.load(out) if os.path.exists(out) else {}
    missing = [k for k in args.keys if k not in rows]
    if missing:
        print(f"[ERROR] unknown cell keys (not in {out}): {missing}",
              file=sys.stderr)
        return 2
    try:
        calls = [grid_call(k, rows[k]) for k in args.keys]
    except ValueError as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 2
    dev = common.pick_device(args.device)
    if dev is None:
        return common.NO_DEVICE_EXIT
    g = rg.Grid(out, dev, reps=int(os.environ.get("SMJ_GRID_REPS", "3")),
                burn=int(os.environ.get("SMJ_GRID_BURN", "2")))
    for k in args.keys:
        g.done.discard(k)
    for k, (name, kw) in zip(args.keys, calls):
        rg.log(f"=== re-running {k}: grid {name} {kw} ===")
        rg.GRIDS[name](g, **kw)
    return 0


if __name__ == "__main__":
    from ..types import default_alloc_conf

    default_alloc_conf()  # before the first CUDA call
    sys.exit(main())
