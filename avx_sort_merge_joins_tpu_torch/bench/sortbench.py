"""Sort micro-benchmark, the bench_sort analog (counterpart of
``avx_sort_merge_joins_tpu/bench/sortbench.py``; reference:
src/bench/sortbench.c, ``[#tuples in 2^20] [variant]``, the sort checked
for sortedness).

Variants: ``pairwise`` (K5, then log2(#blocks) K4 passes; avxsort),
``multiway`` (K5, then K6 levels; avxsort-multiway), ``keysonly`` (K1,
then K2 levels: the count path's sort) and ``torch`` (one ``torch.sort``
of the packed pairs, the std::sort analog; the JAX ``xla``).
``--negative`` keeps the signed keys (the fork's _hybridsort experiment,
sortbench.c:305-370).  ``--block`` is the block sort's size in keys, in
place of the JAX ``--block-rows``/``--tile-rows``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import multiwaymerge as mw, sort as so
from ..params import BLOCKSIZE_DEFAULT
from ..types import device_name
from . import common


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sortbench")
    p.add_argument("mtuples", type=float, nargs="?", default=16.0,
                   help="tuples in 2^20 units (sortbench.c:470)")
    p.add_argument("variant", nargs="?", default="multiway",
                   choices=["pairwise", "multiway", "keysonly", "torch"])
    p.add_argument("--fanin", type=int, default=16)
    p.add_argument("--block", type=int, default=BLOCKSIZE_DEFAULT,
                   choices=so.SUPPORTED_BLOCKS,
                   help="keys per block of the block sort")
    p.add_argument("--negative", action="store_true",
                   help="signed key distribution (fork's debug_pos_neg_sort)")
    p.add_argument("--reps", type=int, default=3)
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    if dev is None:
        return common.NO_DEVICE_EXIT

    n = int(args.mtuples * (1 << 20))
    keys = common.gen_keys(n)
    if not args.negative:
        keys = np.abs(keys)
    kd = torch.from_numpy(keys).to(dev)
    pd = torch.arange(n, dtype=torch.int32, device=dev)

    if args.variant == "pairwise":
        def fn(a, b):
            return so.sort(a, b, n, args.block)
        arrs = (kd, pd)
    elif args.variant == "multiway":
        def fn(a, b):
            return mw.multiway_sort(a, n, args.block, args.fanin, payloads=b)
        arrs = (kd, pd)
    elif args.variant == "keysonly":
        def fn(a):
            return mw.multiway_sort(a, n, args.block, args.fanin)
        arrs = (kd,)
    else:
        def fn(a, b):
            return so.sort_torch(a, b)
        arrs = (kd, pd)

    secs = common.time_steady(fn, *arrs, reps=args.reps)
    out = fn(*arrs)
    got = (out[0] if isinstance(out, tuple) else out)[:n].cpu().numpy()
    if not common.check_sorted(got):
        raise AssertionError("output not sorted")
    mts = n / secs / 1e6
    print(f"[sortbench] variant={args.variant} n={n} "
          f"{secs*1e6:.0f} usecs {mts:.1f} Mtuples/s on {device_name(dev)}",
          file=sys.stderr)
    print(f"{n} {secs*1e6:.0f} {mts:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
