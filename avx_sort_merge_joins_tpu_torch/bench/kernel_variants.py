"""Design choices of K1 (block sort) and K11 (remote-pull push and gated
merge) of the PyTorch port, measured against each other on one NVIDIA GPU,
from the root of a checkout (it takes chip_smoke.py's helpers):

    python -m avx_sort_merge_joins_tpu_torch.bench.kernel_variants

Each variant is a copy of the package in the checkout with one textual
change to its CUDA sources, written under the gitignored csrc/build/variants/
and built there by the package's own builder:

  final            the sources as committed;
  k1_one_cta       K1 allowed 128 registers, one CTA of 512 threads an SM
                   (the committed K1 is capped at 64: two CTAs an SM);
  k1_16_keys       K1 with 16 keys a thread, 1,024 threads a CTA;
  k11_one_tile     K11 with one tile a merge ticket, whose two boundaries
                   two warps search (the committed K11 takes 7 tiles a
                   ticket, 8 warps searching their 8 boundaries at once);
  k11_shared_windows  K11's co-rank windows in shared memory at every
                   shard count (the committed K11 keeps them in registers
                   up to 32 shards, one strip a lane).

Each variant runs in its own process (its own library): K1 on 128M keys,
held against its plain version, mean of 10 launches after 1 warm-up (CUDA
events); K11 on the buckets of R of the 128M x 128M join over 8 shards
(chip_smoke.py's), held against its plain version, a full launch and a
launch with every flag set and no push (the merge alone), means of 10.
The variants run in order, then in reverse order.  Printed: the card's
name and power limit, each variant's registers and stack, its times.
"""

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = "avx_sort_merge_joins_tpu_torch"
CSRC = os.path.join(ROOT, PKG, "csrc")
VARIANTS_DIR = os.path.join(CSRC, "build", "variants")

# name -> (what it measures, [(source, committed text, variant's text)])
VARIANTS = {
    "final": (("k1", "k11"), []),
    "k1_one_cta": (("k1",), [
        ("block_sort.cu", "constexpr int kMinBlocks = 2;",
         "constexpr int kMinBlocks = 1;")]),
    "k1_16_keys": (("k1",), [
        ("block_sort.cu", "constexpr int kPer = 32;",
         "constexpr int kPer = 16;"),
        ("block_sort.cu", "constexpr int kMaxThreads = 512;",
         "constexpr int kMaxThreads = 1024;"),
        ("block_sort.cu", "constexpr int kMinBlocks = 2;",
         "constexpr int kMinBlocks = 1;")]),
    "k11_one_tile": (("k11",), [
        ("remote_pull.cu", "  a.span = group_span(n);",
         "  a.span = 1;")]),
    "k11_shared_windows": (("k11",), [
        ("remote_pull.cu",
         "      if (a.n <= 32)  // one strip a lane: the windows in "
         "registers", "      if (false)")]),
}


def make_variant(name: str) -> str:
    """A copy of the package with the variant's changes; its root."""
    root = os.path.join(VARIANTS_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for src, old, new in VARIANTS[name][1]:
        path = os.path.join(root, PKG, "csrc", src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {src} no longer holds {old!r} once: "
                             "update this script")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def worker(name: str) -> None:
    """Measure one variant; its package comes first on sys.path."""
    sys.path.append(ROOT)  # chip_smoke's helpers, after the variant
    import torch

    import chip_smoke as cs
    from avx_sort_merge_joins_tpu_torch.kernels import _build
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    if not _build.__file__.startswith(os.path.join(VARIANTS_DIR, name)):
        raise SystemExit(f"{name}: imported {_build.__file__}")
    usage = cs.res_usage()
    for fn, line in re.findall(r"Function ([^\s:]+):?\n([^\n]*)", usage):
        if re.search(r"block_sort_kernelILi16384E|remote_pull_kernel", fn):
            res = dict(re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line))
            kernel = "K1" if "block_sort" in fn else "K11"
            print(f"[{name}] {kernel}: REG {res.get('REG')}, STACK "
                  f"{res.get('STACK')}", flush=True)
    dev = torch.device("cuda", 0)
    what = VARIANTS[name][0]
    if "k1" in what:
        gen = torch.Generator(device=dev).manual_seed(7)
        n = cs.MAIN_N
        keys = torch.randint(1, n + 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        if not torch.equal(sort_ops.sort_blocks(keys, n),
                           sort_ops.sort_blocks_plain(keys, n)):
            raise AssertionError(f"{name}: K1 != plain")
        ms = cs.time_ms(lambda: sort_ops.sort_blocks(keys, n), 10)
        print(f"[{name}] K1 {n} keys: {ms:.3f} ms", flush=True)
        del keys
    if "k11" in what:
        _, cap, _, buckets = cs.dist_landings(dev)
        w = cs.DIST_SHARDS
        mesh = make_mesh(w, dev)
        chunk = rf.pick_chunk_elems(cap, dm.TILE_ELEMS, w)
        bflat, rcounts = buckets[0]
        del buckets
        full = rf.remote_pull_exchange_merge(mesh, bflat, rcounts, cap, chunk)
        want = rf.remote_pull_exchange_merge_plain(mesh, bflat, rcounts, cap,
                                                   chunk)
        if not all(torch.equal(a, b) for a, b in zip(full, want)):
            raise AssertionError(f"{name}: K11 != plain")
        k = rf._checked_pull(mesh, bflat, rcounts, cap, chunk, None)
        ms = cs.time_ms(lambda: rf.remote_pull_exchange_merge(
            mesh, bflat, rcounts, cap, chunk), 10)
        merge = cs.time_ms(lambda: rf._pull_launch(
            mesh, bflat, rcounts, cap, chunk, k, landing=full[3]), 10)
        print(f"[{name}] K11 R over {w} shards: {ms:.3f} ms, the merge "
              f"alone {merge:.3f} ms", flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    roots = {name: make_variant(name) for name in VARIANTS}
    order = list(VARIANTS)
    for name in order + order[::-1]:
        env = dict(os.environ, PYTHONPATH=roots[name])
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", name], env=env, check=True, cwd=ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
