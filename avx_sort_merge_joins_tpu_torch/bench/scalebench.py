"""Scaling harness: distributed join throughput against the shard count
(counterpart of ``avx_sort_merge_joins_tpu/bench/scalebench.py``;
reference: scripts/tput-scalability.sh:27-38, the thread-scaling grid, and
src/bench/tputbench.c:902-1018).

Runs the distributed m-way (or ``--algo m-pass|mpsm``) count join at 1, 2,
4, ... shards and reports tuples/s and the efficiency tput(n) / (n *
tput(1)).  An ``HxC`` entry of ``--devices`` is a 2-D ``(host, chip)``
mesh (``make_mesh2d``), with per-axis efficiency columns.  The data is
unique R (a permutation of 1..n) and foreign-key S from
``default_rng(3)``, put on the device once; every count is asserted equal
to the numpy oracle's.

The port's mesh is N shards of one device: on the card the shards share
one H100, so the efficiency column is a structural proxy (it shows the
exchange's and the padding's costs, not an interconnect's gain), as the
JAX harness says of its CPU mesh.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops.mergejoin import merge_join_count_numpy
from ..parallel.mesh import make_mesh, make_mesh2d
from ..types import device_name
from . import common


def _join(algo: str):
    if algo == "m-pass":
        from ..parallel import dist_mpass
        return dist_mpass.dist_mpass_join_count
    if algo == "mpsm":
        # the S ring over every R run: mpsm's scan-all-runs shape shows in
        # these rows against the m-way ones
        from ..parallel import dist_mpsm
        return dist_mpsm.dist_mpsm_join_count
    from ..parallel import dist_mway
    return dist_mway.dist_mway_join_count


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scalebench")
    p.add_argument("ntuples", type=int, nargs="?", default=1 << 22)
    p.add_argument("--devices", default=None,
                   help="comma list of shard counts (default 1,2,4,8); HxC "
                        "entries (e.g. 2x4) run a 2-D ('host','chip') mesh "
                        "with the hierarchical exchange")
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--algo", default="m-way",
                   choices=["m-way", "m-pass", "mpsm"])
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    if dev is None:
        return common.NO_DEVICE_EXIT

    # the JAX default counts its devices; the port's mesh has no device
    # count, so the default list is its 8-device test mesh's
    counts = ([x.strip() for x in args.devices.split(",")] if args.devices
              else ["1", "2", "4", "8"])
    n = args.ntuples
    rng = np.random.default_rng(3)
    rk = rng.permutation(np.arange(1, n + 1)).astype(np.int32)
    sk = rng.integers(1, n + 1, n).astype(np.int32)
    expected = merge_join_count_numpy(rk, sk)
    rkd, skd = torch.from_numpy(rk).to(dev), torch.from_numpy(sk).to(dev)
    del rk, sk
    join = _join(args.algo)
    print(f"[scalebench] {args.algo} on {device_name(dev)}: every mesh is "
          "its shards on this one device, so efficiency is a structural "
          "proxy", file=sys.stderr)

    tput1 = None
    per_count_tput = {}
    for spec_str in counts:
        if "x" in spec_str:
            # 2-D ('host', 'chip') mesh: hierarchical exchange, per-axis
            # efficiency below
            if args.algo == "mpsm":
                print(f"[scalebench] mpsm skipped on 2-D mesh {spec_str} "
                      "(S-ring schedules the flat chip axis only)",
                      file=sys.stderr)
                continue
            h, c = (int(x) for x in spec_str.split("x"))
            mesh = make_mesh2d(h, c, dev)
            nd = h * c
        else:
            nd = int(spec_str)
            mesh = make_mesh(nd, dev)
        cnt, ov = join(rkd, skd, n, n, mesh)  # warm-up + exact check
        if ov != 0 or cnt != expected:
            raise AssertionError(f"scalebench {args.algo} ndev={spec_str}: "
                                 f"count {cnt}, overflow {ov}, want "
                                 f"{expected}")
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            join(rkd, skd, n, n, mesh)  # returns host ints: synced
            best = min(best, time.perf_counter() - t0)
        tput = 2 * n / best
        if tput1 is None:
            tput1 = tput
        per_count_tput[spec_str] = tput
        eff = tput / (nd * tput1)
        cols = [f"efficiency={eff:.2f}"]
        if "x" in spec_str:
            # per-axis efficiency: against the same total over one host
            # (host-axis cost) and the chips-per-host flat point (chip-axis
            # baseline), when those points ran earlier
            flat_c = per_count_tput.get(str(c))
            one_host = per_count_tput.get(f"1x{c}")
            if flat_c:
                cols.append(f"host_axis_eff={tput / (h * flat_c):.2f}")
            if one_host:
                cols.append(f"host_axis_eff_vs_1x={tput / (h * one_host):.2f}")
        print(f"[scalebench] {args.algo} ndev={spec_str} n={n} "
              f"{best*1e6:.0f} usecs {tput/1e6:.1f} Mtuples/s "
              + " ".join(cols) + f" on {device_name(dev)}", file=sys.stderr)
        print(f"{args.algo} {spec_str} {n} {best*1e6:.0f} {tput/1e6:.2f} "
              f"{eff:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
