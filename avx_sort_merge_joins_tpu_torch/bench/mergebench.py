"""Two-way merge micro-benchmark, the bench_merge analog (counterpart of
``avx_sort_merge_joins_tpu/bench/mergebench.py``; reference:
src/bench/mergebench.c, merge kernels on sorted lists checked against a
sort).

Both variants merge two sorted runs of n keys laid out as the uniform-lens
layout ``(2, 2n, n)``: run 0 at ``[0, n)``, run 1 at ``[n, 2n)``, both
ascending.  ``fifo2`` is K2 at fan-in 2; ``pairwise`` is one K4 pass (the
JAX pass takes an (ascending, descending) pair; the port's two ascending
runs).  The output is checked against numpy's sort of the two lists.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import multiwaymerge as mw, sort as so
from ..types import device_name
from . import common


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mergebench")
    p.add_argument("mtuples", type=float, nargs="?", default=8.0,
                   help="per-list tuples in 2^20 units")
    p.add_argument("--variant", default="fifo2",
                   choices=["fifo2", "pairwise"])
    p.add_argument("--reps", type=int, default=3)
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    if dev is None:
        return common.NO_DEVICE_EXIT

    n = max(1, int(args.mtuples * (1 << 20)))
    rng = np.random.default_rng(7)
    a = np.sort(rng.integers(-(2**30), 2**30, n).astype(np.int32))
    b = np.sort(rng.integers(-(2**30), 2**30, n).astype(np.int32))
    keys = torch.from_numpy(np.concatenate([a, b])).to(dev)
    lens = (2, 2 * n, n)

    if args.variant == "fifo2":
        def fn(k):
            return mw.multiway_merge(k, 2, lens)[0]
    else:
        def fn(k):
            return so.merge_pass(k, None, lens)[0]

    secs = common.time_steady(fn, keys, reps=args.reps)
    got = fn(keys)[:2 * n].cpu().numpy()
    if not np.array_equal(got, np.sort(np.concatenate([a, b]))):
        raise AssertionError("merge output mismatch vs oracle")
    mts = 2 * n / secs / 1e6
    print(f"[mergebench] variant={args.variant} 2x{n} "
          f"{secs*1e6:.0f} usecs {mts:.1f} Mtuples/s on {device_name(dev)}",
          file=sys.stderr)
    print(f"{2*n} {secs*1e6:.0f} {mts:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
