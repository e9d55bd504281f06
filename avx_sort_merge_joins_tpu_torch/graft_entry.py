"""Driver entry points of the port (counterpart of ``__graft_entry__.py``).

``entry(device=None)``  -- the flagship single-device forward step: the
                           m-way count of 64K ⋈ 64K keys (K1 block sort,
                           K2 merge levels, K3 fused match count).
``dryrun_multichip(n, device=None)`` -- every distributed join of the port
                           on a mesh of ``n`` shards at |R| = 4,096, |S| =
                           8,192, each leg exact against numpy.

Both run on the card unless the caller names ``device="cpu"``, where every
kernel takes its plain PyTorch version; without a card and with the CPU
not named they raise.  The JAX dryrun's machinery to find ``n`` devices
(``__graft_entry__.py:43-80``: the XLA device-count flag, the fallback to
CPU devices, the re-exec in a fresh process) is not needed: the port's
mesh is ``n`` shards of one device (``parallel/mesh.py``), so any ``n``
fits on one card; ``dryrun_multichip(n, devices=...)`` runs the legs on a
mesh of one device a shard instead.

    python -m avx_sort_merge_joins_tpu_torch.graft_entry [N] [--device cpu]

runs ``entry()``'s forward and ``dryrun_multichip(N)`` (N = 8 by default)
and exits 1 without a card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .kernels import _build

ENTRY_N = 1 << 16  # 64K ⋈ 64K tuples
DRYRUN_NR, DRYRUN_NS = 4096, 8192

# The kernels each leg must launch on the card (kernels._build.launches()):
# a leg that took a plain route would launch none.  dist_join counts with
# the torch.sort baseline and has none.
LEG_KERNELS = {
    "dist_join": (),
    "m-way": ("K1", "K2", "K3"),
    "m-pass": ("K1", "K4", "K3"),
    "remote-pull": ("K1", "K9", "K3"),
    "2-D mesh": ("K1", "K2", "K3"),
    "mpsm": ("K1", "K3"),
    "materialize": ("K1", "K2", "K5", "K6"),
    "zipf": ("K1", "K2", "K3"),
    "remote-pull dma": ("K1", "K11", "K3"),
}


def _device(device) -> torch.device:
    from .types import default_device

    return torch.device(device) if device is not None else default_device()


def entry_inputs() -> tuple[np.ndarray, np.ndarray]:
    """The 64K R and S keys of ``__graft_entry__.py:34-36``: two
    permutations of 1..65,536 from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    rk = rng.permutation(np.arange(1, ENTRY_N + 1)).astype(np.int32)
    sk = rng.permutation(np.arange(1, ENTRY_N + 1)).astype(np.int32)
    return rk, sk


def entry(device=None):
    """``(forward, (rk, sk))``: the flagship m-way count step and its
    inputs on ``device`` (the card by default).  ``forward(rk, sk)`` sorts
    each side by the keys-only multiway sort (K1, then the K2 levels) and
    counts the matches with K3; it returns the count as an int64 0-d
    tensor on the device (65,536 for these inputs).  Building the inputs
    compiles and launches nothing."""
    from .models import mway
    from .ops import mergejoin
    from .ops import multiwaymerge as mw

    dev = _device(device)
    n = ENTRY_N

    def forward(rk: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
        rks = mw.multiway_sort(rk, n, mway.BLOCK_MWAY, mway.FANIN_DEFAULT)
        sks = mw.multiway_sort(sk, n, mway.BLOCK_MWAY, mway.FANIN_DEFAULT)
        return mergejoin.merge_join_count_fused(rks, sks, n, n)

    rk, sk = entry_inputs()
    return forward, (torch.from_numpy(rk).to(dev),
                     torch.from_numpy(sk).to(dev))


def dryrun_inputs():
    """The dryrun's relations (``__graft_entry__.py:87-92``, ``:148-150``):
    R a permutation of 1..4,096 and S 8,192 uniform keys over it from
    ``default_rng(1)``, payloads 0..n-1, and the Zipf S of
    ``create_relation_zipf(8192, 4096, 1.0)`` after
    ``seed_generator(12345)``.  Returns ``(rk, rp, sk, sp, sk_zipf)``,
    numpy int32."""
    from . import datagen

    rng = np.random.default_rng(1)
    rk = rng.permutation(np.arange(1, DRYRUN_NR + 1)).astype(np.int32)
    sk = rng.integers(1, DRYRUN_NR + 1, DRYRUN_NS).astype(np.int32)
    rp = np.arange(DRYRUN_NR, dtype=np.int32)
    sp = np.arange(DRYRUN_NS, dtype=np.int32)
    datagen.seed_generator(12345)
    sk_z = datagen.create_relation_zipf(DRYRUN_NS, DRYRUN_NR, 1.0,
                                        device="cpu").keys.numpy()
    return rk, rp, sk, sp, sk_z


def _leg(name: str, run, expected: int, on_card: bool) -> dict:
    """Run one leg: ``run()`` returns ``(count, overflow)``.  Raises, the
    leg named, unless the overflow is 0, the count ``expected`` and, on
    the card, every kernel of ``LEG_KERNELS[name]`` launched.  Returns the
    leg's count and launches."""
    before = _build.launches()
    cnt, overflow = run()
    if on_card:
        torch.cuda.synchronize()
    launched = dict(_build.launches() - before)
    if overflow != 0:
        raise AssertionError(f"{name}: bucket overflow {overflow}")
    if cnt != expected:
        raise AssertionError(f"{name}: count {cnt} != expected {expected}")
    idle = [k for k in LEG_KERNELS[name] if on_card and k not in launched]
    if idle:
        raise AssertionError(f"{name}: never launched {idle} "
                             f"(launches {launched})")
    return {"count": cnt, "launches": launched}


def dryrun_multichip(n_devices: int, device=None, devices=None) -> dict:
    """The JAX dryrun's legs on a mesh of ``n_devices`` shards of
    ``device`` (the card by default), or with ``devices`` on the mesh of
    one device a shard that they make (shard ``me`` on ``devices[me]``, a
    device list that may repeat one device; the 2-D leg on the same
    devices), and a ninth, the real push (``remote_pull="dma"``, K11).  Each leg must count exactly
    ``merge_join_count_numpy``'s number with overflow 0 and, on the card,
    launch its kernels (``LEG_KERNELS``); a failing leg raises with its
    name.  The 2-D leg runs when ``n_devices`` is even and at least 4, as
    in the JAX dryrun; the dma leg when it is a power of two >= 2, which
    K11 needs.  Prints the JAX dryrun's closing line; returns each leg's
    count and launches, by leg."""
    from .ops.mergejoin import merge_join_count_numpy
    from .parallel import (dist_join, dist_materialize, dist_mpass,
                           dist_mpsm, dist_mway)
    from .parallel.mesh import make_mesh, make_mesh2d

    mesh = make_mesh(n_devices, None if devices else _device(device),
                     devices=devices)
    dev = mesh.device
    on_card = dev.type == "cuda"
    n_r, n_s = DRYRUN_NR, DRYRUN_NS
    rk_np, rp_np, sk_np, sp_np, skz_np = dryrun_inputs()
    expected = merge_join_count_numpy(rk_np, sk_np)
    expected_z = merge_join_count_numpy(rk_np, skz_np)
    rk, rp, sk, sp, sk_z = (torch.from_numpy(a).to(dev) for a in
                            (rk_np, rp_np, sk_np, sp_np, skz_np))
    legs = {}

    def leg(name, run, want=expected):
        legs[name] = _leg(name, run, want, on_card)

    # range partition + all-to-all + the torch.sort baseline count
    leg("dist_join", lambda: dist_join.dist_join_count(rk, rp, sk, sp, n_r,
                                                       n_s, mesh))
    # the m-way pipeline: local multiway sort, splitters, bulk exchange,
    # varlen K2 merge of the received runs, K3 count
    leg("m-way", lambda: dist_mway.dist_mway_join_count(rk, sk, n_r, n_s,
                                                        mesh))
    leg("m-pass", lambda: dist_mpass.dist_mpass_join_count(rk, sk, n_r, n_s,
                                                           mesh))
    # the received runs through the chunk-gated receiver K9
    leg("remote-pull", lambda: dist_mway.dist_mway_join_count(
        rk, sk, n_r, n_s, mesh, remote_pull="emulate"))
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh2 = make_mesh2d(2, n_devices // 2, None if devices else dev,
                            devices=devices)
        leg("2-D mesh", lambda: dist_mway.dist_mway_join_count(
            rk, sk, n_r, n_s, mesh2))
    leg("mpsm", lambda: dist_mpsm.dist_mpsm_join_count(rk, sk, n_r, n_s,
                                                       mesh))

    def materialize():
        ok, _, cnt, ov = dist_materialize.dist_join_materialize(
            rk, rp, sk, sp, n_r, n_s, mesh)
        if len(ok) != cnt:
            raise AssertionError(f"materialize: {len(ok)} rows, count {cnt}")
        return cnt, ov

    leg("materialize", materialize)
    leg("zipf", lambda: dist_mway.dist_mway_join_count(rk, sk_z, n_r, n_s,
                                                       mesh), expected_z)
    if n_devices >= 2 and n_devices & (n_devices - 1) == 0:
        # the real push: one K11 launch a relation
        leg("remote-pull dma", lambda: dist_mway.dist_mway_join_count(
            rk, sk, n_r, n_s, mesh, remote_pull="dma"))
    print(f"[dryrun_multichip] {n_devices} devices: "
          f"count={legs['dist_join']['count']} OK ({len(legs)} legs: "
          f"{', '.join(legs)})")
    return legs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="avx_sort_merge_joins_tpu_torch.graft_entry",
        description="the flagship forward step and the distributed dryrun")
    p.add_argument("n_devices", type=int, nargs="?", default=8,
                   help="shards of the dryrun's mesh")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default; exit 1 without one), or the CPU "
                        "through the kernels' plain PyTorch versions")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[ERROR] no CUDA device (torch.cuda.is_available() is false); "
              "pass --device cpu for the plain PyTorch versions",
              file=sys.stderr)
        return 1
    forward, inputs = entry(args.device)
    print(f"[entry] {ENTRY_N} x {ENTRY_N}: count={int(forward(*inputs))}")
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
