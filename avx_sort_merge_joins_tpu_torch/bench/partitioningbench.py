"""Radix-partitioning micro-benchmark, the bench_partitioning analog
(counterpart of ``avx_sort_merge_joins_tpu/bench/partitioningbench.py``;
reference: src/bench/partitioningbench.c, ``NUMTUPLES WHATTODO
RDXBITS``, swept over bits 2..16 by scripts/partitioning-bench.sh).

Variants: ``hist`` (K8 per tile, summed; every bits value: the JAX
package's skip past 2^7 has no cause here), ``hist-mxu`` (``radix_hist_mxu``,
a plain histogram), ``hist-torch`` (the scatter-add yardstick, the JAX
``hist-xla``), ``partition`` (the full padded layout; a stable sort and a
scatter, not a kernel roofline) and ``copy`` (``x + 1``, the copy
roofline).  Each histogram is checked against ``radix_hist_torch``, and the
partition's live slices against ``radix_cluster_numpy``, before its row is
printed: ``NAME USECS MTUPLES/S`` on stdout, ``[partbench] ...`` with the
device on stderr.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import partition as pt
from ..types import device_name
from . import common

VARIANTS = ("hist", "hist-mxu", "hist-torch", "partition", "copy")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="partitioningbench")
    p.add_argument("ntuples", type=int, nargs="?", default=8 * (1 << 20),
                   help="tuples (reference default 8M), rounded down to "
                        "whole 65,536-key tiles")
    p.add_argument("what", nargs="?", default="all",
                   choices=[*VARIANTS, "all"])
    p.add_argument("rdxbits", type=int, nargs="?", default=7)
    p.add_argument("--reps", type=int, default=3)
    common.add_device_arg(p)
    args = p.parse_args(argv)
    try:
        pt.check_radix(args.rdxbits, 0)
    except ValueError as e:
        p.error(str(e))
    dev = common.pick_device(args.device)
    if dev is None:
        return common.NO_DEVICE_EXIT

    n = (args.ntuples // pt.HIST_TILE) * pt.HIST_TILE or pt.HIST_TILE
    nbits = args.rdxbits
    rng = np.random.default_rng(11)
    keys = rng.integers(1, 2**26, n).astype(np.int32)
    kd = torch.from_numpy(keys).to(dev)
    pd = torch.arange(n, dtype=torch.int32, device=dev)
    want = pt.radix_hist_torch(kd, nbits)
    where = device_name(dev)

    def report(name, secs, hist=None, note=""):
        if hist is not None and not torch.equal(hist, want):
            raise AssertionError(f"{name}: histogram != radix_hist_torch")
        print(f"[partbench] {name:10s} n={n} bits={nbits} "
              f"{secs*1e6:.0f} usecs {n/secs/1e6:.1f} Mtuples/s{note} "
              f"on {where}", file=sys.stderr)
        print(f"{name} {secs*1e6:.0f} {n/secs/1e6:.2f}")

    def run(fn, *arrs):
        return common.time_steady(fn, *arrs, reps=args.reps), fn(*arrs)

    if args.what in ("hist", "all"):
        secs, hist = run(lambda x: pt.radix_hist(x, nbits).sum(
            0, dtype=torch.int32), kd)
        report("hist", secs, hist, " (K8 per tile)")
    if args.what in ("hist-mxu", "all"):
        secs, hist = run(lambda x: pt.radix_hist_mxu(x, nbits),
                         kd)
        report("hist-mxu", secs, hist)
    if args.what in ("hist-torch", "all"):
        secs, hist = run(lambda x: pt.radix_hist_torch(x, nbits), kd)
        report("hist-torch", secs, hist, " (scatter-add)")
    if args.what in ("partition", "all"):
        secs, (pk, pp, offsets, sizes) = run(
            lambda x, y: pt.partition_relation(x, y, nbits),
            kd, pd)
        ok, op, _ = pt.radix_cluster_numpy(keys, np.arange(n, dtype=np.int32),
                                           nbits)
        lk, lp = pt.partition_live(pk, pp, offsets, sizes)
        if not (np.array_equal(lk.cpu().numpy(), ok)
                and np.array_equal(lp.cpu().numpy(), op)):
            raise AssertionError("partition: live slices != "
                                 "radix_cluster_numpy")
        report("partition", secs, sizes,
               " (stable sort + scatter; not a kernel roofline)")
    if args.what in ("copy", "all"):
        secs, _ = run(lambda x: x + 1, kd)
        report("copy", secs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
