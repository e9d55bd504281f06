"""Multiway-merge micro-benchmark, the bench_multiwaymerge analog
(counterpart of ``avx_sort_merge_joins_tpu/bench/multiwaymergebench.py``;
reference: src/bench/multiwaymergebench.c, ``chunksize fanIn``, printing
usecs, tuples/s and MB/s, :214-221).

``mway`` merges ``fanin`` sorted runs of ``chunksize`` keys with K2 (the
uniform-lens layout ``(fanin, n, chunksize)``) and checks the output is
sorted; ``torch`` is one ``torch.sort`` of the same keys (the scalar
analog; the JAX ``xla``); ``copy`` is ``x + 1``, the copy roofline.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import multiwaymerge as mw
from ..types import device_name
from . import common


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="multiwaymergebench")
    p.add_argument("chunksize", type=int, nargs="?", default=1 << 20,
                   help="tuples per sorted input run")
    p.add_argument("fanin", type=int, nargs="?", default=16)
    p.add_argument("--what", default="all",
                   choices=["mway", "torch", "copy", "all"])
    p.add_argument("--reps", type=int, default=3)
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    if dev is None:
        return common.NO_DEVICE_EXIT

    chunk, fanin = args.chunksize, args.fanin
    n = chunk * fanin
    rng = np.random.default_rng(9)
    runs = [np.sort(rng.integers(-(2**30), 2**30, chunk).astype(np.int32))
            for _ in range(fanin)]
    keys = torch.from_numpy(np.concatenate(runs)).to(dev)
    where = device_name(dev)

    def report(name, secs):
        mbs = n * 4 / secs / 1e6
        print(f"[mwaymergebench] {name:6s} fanin={fanin} chunk={chunk} "
              f"{secs*1e6:.0f} usecs {n/secs/1e6:.1f} Mtuples/s "
              f"{mbs:.0f} MB/s on {where}", file=sys.stderr)
        print(f"{name} {secs*1e6:.0f} {n/secs/1e6:.2f} {mbs:.0f}")

    if args.what in ("mway", "all"):
        def merge(x):
            return mw.multiway_merge(x, fanin, (fanin, n, chunk))[0]
        secs = common.time_steady(merge, keys, reps=args.reps)
        if not common.check_sorted(merge(keys)[:n].cpu().numpy()):
            raise AssertionError("multiway output not sorted")
        report("mway", secs)
    if args.what in ("torch", "all"):
        report("torch", common.time_steady(lambda x: torch.sort(x).values,
                                           keys, reps=args.reps))
    if args.what in ("copy", "all"):
        report("copy", common.time_steady(lambda x: x + 1, keys,
                                          reps=args.reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
