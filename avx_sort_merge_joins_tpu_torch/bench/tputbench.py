"""Phase-throughput benchmark, the tputbench analog (counterpart of
``avx_sort_merge_joins_tpu/bench/tputbench.py``; reference:
src/bench/tputbench.c, per-phase throughput prints :319-325,556-562).

Modes:
  tput -- the m-way phases timed alone: SORT-BLOCKS (K1), MERGE (the K2
          levels: the full multiway sort less the block sort) and MJOIN
          (K3), in tuples/s.
  mpsm -- sweep ``--nchunks`` over the mpsm join of unique R and uniform
          foreign-key S, the count asserted equal to |S|: each added S
          chunk is one more full scan of sorted R in the count.
  numa -- the numabench analog (tputbench.c:665-1171) on a mesh of 8
          shards of the one device, the JAX default mesh under its
          8-device setting: the all-to-all of an ``(8, n)`` int32 stack
          (``Mesh.all_to_all``), then the read-and-reduce aggregation, one
          ``Mesh.ppermute`` round an offset of ``shuffle_order(-S, 8)``
          reduced into a 128-lane accumulator, checked against numpy's sum
          of the same rows.  On one card both are device-side copies, not
          an interconnect.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import mergejoin as mj, multiwaymerge as mw
from ..types import device_name
from . import common

NUMA_SHARDS = 8  # the JAX numa mode's mesh under its 8-device setting


def run_tput(n: int, fanin: int, reps: int, dev: torch.device) -> int:
    from ..models.mway import BLOCK_MWAY as block

    kd = torch.from_numpy(common.gen_keys(n)).to(dev)
    t_block = common.time_steady(
        lambda a: mw.sort_blocks_phase(a, n, block), kd, reps=reps)
    t_full = common.time_steady(
        lambda a: mw.multiway_sort(a, n, block, fanin), kd, reps=reps)
    r2 = mw.multiway_sort(kd, n, block, fanin)
    t_join = common.time_steady(
        lambda a, b: mj.merge_join_count_fused(a, b, n, n), r2, r2, reps=reps)
    for name, secs in [("SORT-BLOCKS", t_block),
                       ("MERGE", max(t_full - t_block, 1e-9)),
                       ("MJOIN", t_join)]:
        print(f"[tputbench] {name:12s} {secs*1e6:12.0f} usecs "
              f"{n/secs/1e6:10.1f} Mtuples/s on {device_name(dev)}",
              file=sys.stderr)
    print(f"{t_block*1e6:.0f} {max(t_full-t_block,0)*1e6:.0f} "
          f"{t_join*1e6:.0f} {n} {t_full*1e6:.0f} {n/t_full/1e6:.2f}")
    return 0


def run_numa(n_per_chip: int, strategy: str, reps: int,
             dev: torch.device) -> int:
    from ..parallel.mesh import make_mesh, shuffle_order

    mesh = make_mesh(NUMA_SHARDS, dev)
    ndev = mesh.n
    if n_per_chip % ndev or n_per_chip < 128:
        print(f"[ERROR] numa mode: -n {n_per_chip} must be a multiple of "
              f"{ndev} and at least 128", file=sys.stderr)
        return 2
    order = shuffle_order(strategy, ndev)
    print(f"[tputbench] numabench over {ndev} shards of one device "
          f"({device_name(dev)}), strategy={strategy} "
          f"order={order.tolist()}", file=sys.stderr)
    # small seeded values: the int32 lane sums cannot wrap
    host = np.random.default_rng(5).integers(
        0, 100, (ndev, n_per_chip)).astype(np.int32)
    x = torch.from_numpy(host).to(dev)

    secs = common.time_steady(mesh.all_to_all, x, reps=reps)
    gb = ndev * n_per_chip * 4 / 1e9
    print(f"[tputbench] ALL-TO-ALL {secs*1e6:.0f} usecs "
          f"{gb/secs:.1f} GB/s aggregate", file=sys.stderr)

    # the read-only aggregation under the shuffle order, the second half of
    # numabench: one permute round an offset, each arriving shard's rows
    # reduced into a 128-lane accumulator (no gathered copy kept)
    rows = n_per_chip // 128

    def aggregate(v):
        x2 = v[:, :rows * 128].reshape(ndev, rows, 128)
        acc = torch.zeros((ndev, 128), dtype=torch.int32, device=v.device)
        for off in order.tolist():
            y = x2 if off == 0 else mesh.ppermute(
                x2, [(s, (s - off) % ndev) for s in range(ndev)])
            acc += y.sum(1, dtype=torch.int32)
        return acc

    secs_a = common.time_steady(aggregate, x, reps=reps)
    # every shard receives every shard's rows once
    want = host[:, :rows * 128].reshape(ndev, rows, 128).sum((0, 1))
    if not np.array_equal(aggregate(x).cpu().numpy(),
                          np.broadcast_to(want, (ndev, 128))):
        raise AssertionError("numa aggregation != numpy's sum of the rows")
    # remote reads only: the off == 0 round is a local reduce
    gb_a = ndev * (ndev - 1) * rows * 128 * 4 / 1e9
    print(f"[tputbench] AGGREGATION {secs_a*1e6:.0f} usecs "
          f"{gb_a/secs_a:.1f} GB/s aggregate read, checked against numpy",
          file=sys.stderr)
    print(f"{secs*1e6:.0f} {gb/secs:.2f} {secs_a*1e6:.0f} {gb_a/secs_a:.2f}")
    return 0


def run_mpsm(n: int, chunks: list[int], reps: int, dev: torch.device) -> int:
    from ..models import mpsm
    from ..types import Relation

    rk = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    sk = torch.from_numpy(np.random.default_rng(9).integers(
        1, n + 1, size=n, dtype=np.int32)).to(dev)
    R = Relation(rk, torch.zeros_like(rk), n)
    S = Relation(sk, torch.zeros_like(sk), n)
    for nc in chunks:
        best = None
        for _ in range(max(1, reps)):
            res = mpsm.sortmergejoin_mpsm(R, S, nchunks=nc)
            if res.totalresults != n:
                raise AssertionError(f"mpsm nchunks={nc}: "
                                     f"{res.totalresults} != {n}")
            if best is None or res.phases["total"] < best.phases["total"]:
                best = res
        ph = best.phases
        print(f"[tputbench] MPSM nchunks={nc:3d} "
              f"SORT {ph['sort']*1e6:12.0f} usecs "
              f"MJOIN {ph['mergejoin']*1e6:12.0f} usecs "
              f"{2*n/ph['total']/1e6:10.1f} Mtuples/s on {device_name(dev)}",
              file=sys.stderr)
        print(f"{nc} {ph['sort']*1e6:.0f} {ph['mergejoin']*1e6:.0f} "
              f"{2*n} {ph['total']*1e6:.0f} {2*n/ph['total']/1e6:.2f}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tputbench")
    p.add_argument("--mode", default="tput", choices=["tput", "numa", "mpsm"])
    p.add_argument("-n", "--ntuples", type=int, default=1 << 24)
    p.add_argument("-f", "--fanin", type=int, default=16)
    p.add_argument("-S", "--strategy", default="NEXT",
                   choices=["NEXT", "RING", "RANDOM"],
                   help="numa mode: the shuffle order")
    p.add_argument("--nchunks", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="mpsm mode: chunk counts to sweep")
    p.add_argument("--reps", type=int, default=3)
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    if dev is None:
        return common.NO_DEVICE_EXIT
    if args.mode == "mpsm":
        return run_mpsm(args.ntuples, args.nchunks, args.reps, dev)
    if args.mode == "numa":
        return run_numa(args.ntuples, args.strategy, args.reps, dev)
    return run_tput(args.ntuples, args.fanin, args.reps, dev)


if __name__ == "__main__":
    sys.exit(main())
