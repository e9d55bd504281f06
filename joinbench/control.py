"""The control of ``correct``: the plain reference put in the program's
place, with its keys held in float32, the nearest lower precision for
32-bit integer keys (a 24-bit significand: keys past 2^24 that differ in
their low bits become one key).  It breaks the guarantee every
configuration states, an exact join of int32 keys, the way a tempting
shortcut would (sorting or comparing keys as floats), and the comparison
in ``check.py`` has to find it not correct.

    python3 -m joinbench.control --workload <cell> --seeds <n> [<n> ...]

makes the cell's relations from each seed at the cell's own size, runs
the control once in the program's place and prints, a line a seed, the
numbers compared with their limits and ``correct``.  The benchmark's own
runs never run it.  ``--device cpu --tuples N`` are for the tests.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import check, gen, reference, spec
from .run import sizes


def lower_precision(keys: torch.Tensor) -> torch.Tensor:
    """The keys as float32 holds them, back in the keys' type."""
    out = torch.empty_like(keys)
    for lo in range(0, keys.numel(), reference.CHUNK):
        part = keys[lo:lo + reference.CHUNK]
        out[lo:lo + reference.CHUNK] = part.float().to(torch.int64)
    return out


def control_run(cell: spec.Cell, seed: int, device, tuples=None) -> dict:
    """One seed: the relations, the control's answer in the program's
    place, and the comparison's checks."""
    n_r, n_s = sizes(cell.config, tuples)
    rel = gen.make_relations(n_r, n_s, cell.traffic, seed, device,
                             bool(cell.config["payload_columns"]),
                             gen.key_bytes(cell.config, cell.traffic))
    rk, sk = lower_precision(rel.r_keys), lower_precision(rel.s_keys)
    if cell.entry.ANSWER == "rows":
        positions = check.sample_positions(n_s, seed, device)
        rows = reference.unpack(reference.rows(rk, sk, rel.s_payloads))
        del rk, sk
        answers = [{"count": int(rows[0].numel()),
                    "rows": check.read_rows(rows, positions)}]
        checks, failed = check.compare(rel, answers, rows, positions)
    else:
        answers = [{"count": reference.count(rk, sk)}]
        del rk, sk
        checks, failed = check.compare(rel, answers)
    return {"workload": cell.name, "seed": seed,
            "correct": check.is_correct(checks), "failed": failed,
            "checks": checks}


def main(argv=None, root=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m joinbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--tuples", type=int, default=None)
    args = p.parse_args(argv)
    cell = spec.load_cell(Path(root) if root else spec.default_root(),
                          args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("joinbench.control: no CUDA device", file=sys.stderr)
        return 1
    for seed in args.seeds:
        print(json.dumps(control_run(cell, seed, torch.device(args.device),
                                     args.tuples)), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
