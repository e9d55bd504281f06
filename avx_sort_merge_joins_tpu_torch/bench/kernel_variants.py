"""Design choices of K1 (block sort), K3 (match count), K5 (pair block
sort) and K11 (remote-pull push and gated merge) of the PyTorch port,
measured against each other on one NVIDIA GPU, from the root of a
checkout (it takes chip_smoke.py's helpers):

    python -m avx_sort_merge_joins_tpu_torch.bench.kernel_variants [k1 k3 ...]

(the variants of the kernels named among k1, k3, k5, k11, default all;
``final`` always runs).

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
                   up to 32 shards, one strip a lane);
  k3_group_4, k3_group_16  K3 with 4 or 16 tiles a CTA (the committed
                   K3: 8 tiles of 1,920, 15 merged elements a thread, 128
                   threads, windows of 2,048);
  k3_tile_7        K3 with 7 merged elements a thread: tiles of 896 in
                   windows of 1,024;
  k3_256_threads   K3 with 256 threads a CTA: tiles of 3,840 in windows
                   of 4,096;
  k3_copy_ahead    K3 copying the next tile's keys during this tile's walk
                   (windows of 4,096; the committed K3 copies a tile's
                   keys when it comes to it);
  k3_32_registers  K3 capped at 32 registers, for 16 CTAs an SM;
  k3_part_*        timing only, their output is wrong: K3 making its
                   global searches and nothing else, or copying its tiles
                   and splitting them without walking them;
  k5_network_only  K5 sorting each whole block with the bitonic network
                   (the committed K5 sorts each thread's 16 pairs with its
                   register phases and merges those runs in log2(B / 16)
                   merge-path rounds);
  k5_runs_<n>      K5 with the network up to runs of n pairs, across
                   threads by shuffles (n <= 512) and shared memory;
  k5_32_pairs      K5 with 32 pairs a thread, 512 threads a CTA at
                   16,384 (up to 128 registers; the committed K5: 16
                   pairs, 1,024 threads, at most 64 registers);
  k5_part_*        timing only, their output is wrong: K5 without its
                   network, or without its merge rounds.
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
    "final": (("k1", "k3", "k5", "k11"), []),
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
    "k3_group_4": (("k3",), [
        ("merge_join_count.cu", "constexpr int kCountGroup = 8;",
         "constexpr int kCountGroup = 4;")]),
    "k3_group_16": (("k3",), [
        ("merge_join_count.cu", "constexpr int kCountGroup = 8;",
         "constexpr int kCountGroup = 16;")]),
    "k3_tile_7": (("k3",), [
        ("merge_join_count.cu", "constexpr int kCountPer = 15;",
         "constexpr int kCountPer = 7;"),
        ("merge_join_count.cu", "constexpr int kCountWindow = 2048;",
         "constexpr int kCountWindow = 1024;")]),
    "k3_256_threads": (("k3",), [
        ("merge_join_count.cu", "constexpr int kCountThreads = 128;",
         "constexpr int kCountThreads = 256;"),
        ("merge_join_count.cu", "constexpr int kCountWindow = 2048;",
         "constexpr int kCountWindow = 4096;")]),
    "k3_copy_ahead": (("k3",), [
        ("merge_join_count.cu", "constexpr int kCountAhead = 0;",
         "constexpr int kCountAhead = 1;"),
        ("merge_join_count.cu", "constexpr int kCountWindow = 2048;",
         "constexpr int kCountWindow = 4096;")]),
    "k3_32_registers": (("k3",), [
        ("merge_join_count.cu", "__launch_bounds__(kCountThreads)",
         "__launch_bounds__(kCountThreads, 16)")]),
    "k3_part_search": (("k3",), [
        ("merge_join_count.cu",
         "  for (int d = 0; d < span; d += kCountTile) {",
         "  for (int d = span; d < span; d += kCountTile) {")]),
    "k3_part_no_walk": (("k3",), [
        ("merge_join_count.cu", "    if (dl < D) {", "    if (false) {")]),
    "k5_network_only": (("k5",), [
        ("block_sort_pairs.cu", "constexpr int kRunMax = kPer;",
         "constexpr int kRunMax = 16384;")]),
    **{f"k5_runs_{n}": (("k5",), [
        ("block_sort_pairs.cu", "constexpr int kRunMax = kPer;",
         f"constexpr int kRunMax = {n};")]) for n in (32, 128, 512, 2048)},
    "k5_32_pairs": (("k5",), [
        ("block_sort_pairs.cu", "constexpr int kPer = 16;",
         "constexpr int kPer = 32;"),
        ("block_sort_pairs.cu", "constexpr int kMaxThreads = 1024;",
         "constexpr int kMaxThreads = 512;")]),
    "k5_part_no_network": (("k5",), [
        ("block_sort_pairs.cu",
         "  smj_bitonic::sort_regs<long long, kPer, kRun>(x, ptile);\n",
         "")]),
    "k5_part_no_merge": (("k5",), [
        ("block_sort_pairs.cu", "  merge_rounds<kRun, kBlock>(x, ptile);\n",
         "")]),
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


def worker(name: str, kernels: list[str]) -> None:
    """Measure one variant; its package comes first on sys.path."""
    sys.path.append(ROOT)  # chip_smoke's helpers, after the variant
    import torch

    import chip_smoke as cs
    from avx_sort_merge_joins_tpu_torch.kernels import _build
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    if not _build.__file__.startswith(os.path.join(VARIANTS_DIR, name)):
        raise SystemExit(f"{name}: imported {_build.__file__}")
    usage = cs.res_usage()
    kinds = {"block_sort_kernelILi16384E": "K1",
             "merge_join_count_kernel": "K3",
             "block_sort_pairs_kernelILi16384E": "K5",
             "remote_pull_kernel": "K11"}
    for fn, line in re.findall(r"Function ([^\s:]+):?\n([^\n]*)", usage):
        for pattern, kernel in kinds.items():
            if pattern in fn:
                res = dict(re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line))
                print(f"[{name}] {kernel}: REG {res.get('REG')}, STACK "
                      f"{res.get('STACK')}, LOCAL {res.get('LOCAL')}",
                      flush=True)
    dev = torch.device("cuda", 0)
    what = [k for k in VARIANTS[name][0] if k in kernels]
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
    if "k3" in what:
        gen = torch.Generator(device=dev).manual_seed(7)
        n = cs.MAIN_N
        rk = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
        for ns in (n, n // 4):
            sk = torch.sort(torch.randint(1, n + 1, (ns,), generator=gen,
                                          dtype=torch.int32,
                                          device=dev)).values
            exact = int(mergejoin.merge_join_count_fused(rk, sk, n, ns)) \
                == int(mergejoin.merge_join_count_fused_plain(rk, sk, n, ns))
            if exact == name.startswith("k3_part_"):
                raise AssertionError(f"{name}: K3 exact={exact}")
            ms = cs.time_ms(lambda: mergejoin.merge_join_count_fused(
                rk, sk, n, ns), 10)
            print(f"[{name}] K3 {n} x {ns}: {ms:.3f} ms", flush=True)
            del sk
        del rk
    if "k5" in what:
        gen = torch.Generator(device=dev).manual_seed(11)
        n = cs.MAIN_N
        keys = torch.randint(1, n + 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        pays = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        for desc in (False, True):
            got = sort_ops.sort_blocks_pairs(keys, pays, n, descending=desc)
            want = sort_ops.sort_blocks_pairs_plain(keys, pays, n,
                                                    descending=desc)
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            if exact == name.startswith("k5_part_"):
                raise AssertionError(f"{name}: K5 exact={exact}")
            del got, want
            ms = cs.time_ms(lambda: sort_ops.sort_blocks_pairs(
                keys, pays, n, descending=desc), 10)
            print(f"[{name}] K5 {n} pairs descending={desc}: {ms:.3f} ms",
                  flush=True)
        del keys, pays
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
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3:])
        return 0
    kernels = sys.argv[1:] or ["k1", "k3", "k5", "k11"]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    order = [name for name, (what, _) in VARIANTS.items()
             if name == "final" or set(what) & set(kernels)]
    roots = {name: make_variant(name) for name in order}
    for name in order + order[::-1]:
        env = dict(os.environ, PYTHONPATH=roots[name])
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", name, *kernels], env=env, check=True,
                       cwd=ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
