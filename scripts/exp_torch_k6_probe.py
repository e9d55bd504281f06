"""A/B of the probe of K6, the pair multiway merge of the PyTorch port
(avx_sort_merge_joins_tpu_torch/csrc/multiway_merge.cu), on one NVIDIA GPU:

    python3 scripts/exp_torch_k6_probe.py

Each step of K6's binary searches compares a (key, payload) pair.  The
kernel as committed ("eager") loads both planes at the probed index at once
and compares one packed int64.  The variant ("lazy") loads the key plane
and, only when the keys tie, the payload plane: fewer loads, but a second
dependent round of latency on every tie.  The script builds both from the
sources in the checkout (the lazy one from a patched copy of
smj_common.cuh in a temporary directory), runs every level of a 128M-pair
sort on two inputs -- foreign keys with random payloads (the materializing
join's S: keys tie only near the end of a search) and the KEY_8B planes of
int32 keys (the hi plane is constant: every step ties) -- holds each result
against the plain version, and prints the mean of 3 runs after 1 warm-up
per level and variant, with the card's name and power limit.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from avx_sort_merge_joins_tpu_torch.kernels import _build  # noqa: E402
from avx_sort_merge_joins_tpu_torch.ops import join64  # noqa: E402
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw  # noqa: E402
from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops  # noqa: E402

N = 128_000_000
CSRC = os.path.dirname(_build.BUILD_DIR)
EAGER = '''    const long long m = smj_pack(__ldg(k + mid), __ldg(p + mid));
    if (kUpper ? m <= v : m < v) lo = mid + 1; else hi = mid;
'''
LAZY = '''    const int km = __ldg(k + mid);
    bool before;
    if (km != smj_key(v)) {
      before = km < smj_key(v);
    } else {
      const int pm = __ldg(p + mid);
      before = kUpper ? pm <= smj_payload(v) : pm < smj_payload(v);
    }
    if (before) lo = mid + 1; else hi = mid;
'''


def build_variant(tmp: str, lazy: bool) -> ctypes.CDLL:
    d = os.path.join(tmp, "lazy" if lazy else "eager")
    os.makedirs(d)
    for f in ("smj_common.cuh", "multiway_merge.cu"):
        shutil.copy(os.path.join(CSRC, f), d)
    if lazy:
        path = os.path.join(d, "smj_common.cuh")
        with open(path) as f:
            header = f.read()
        if EAGER not in header:
            raise SystemExit("smj_pair_bound's loop body has changed: "
                             "update EAGER in this script")
        with open(path, "w") as f:
            f.write(header.replace(EAGER, LAZY))
    lib_path = os.path.join(d, "libk6.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    lib_path, os.path.join(d, "multiway_merge.cu")],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.smj_multiway_merge.argtypes = [p, p, p, p, i64, i64, i64,
                                       ctypes.c_int, p]
    lib.smj_multiway_merge.restype = ctypes.c_int
    return lib


def time_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    keys = torch.randint(1, N + 1, (N,), generator=gen, dtype=torch.int32,
                         device=dev)
    pays = torch.randint(-2**31, 2**31 - 1, (N,), generator=gen,
                         dtype=torch.int32, device=dev)
    inputs = {"fk keys, random payloads": (keys, pays),
              "KEY_8B planes of int32 keys": join64.widen32(keys)}
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"eager": build_variant(tmp, False),
                "lazy": build_variant(tmp, True)}
        for name, (k, p) in inputs.items():
            rk, rp = sort_ops.sort_blocks_pairs(k, p, N)
            for level in mw.merge_levels(N, 16384, 16):
                _, span, nruns, w = level
                want = mw.multiway_merge_plain(rk, w, (nruns, N, span), rp)
                for variant, lib in libs.items():
                    ok, op = torch.empty_like(rk), torch.empty_like(rp)

                    def run():
                        code = lib.smj_multiway_merge(
                            rk.data_ptr(), rp.data_ptr(), ok.data_ptr(),
                            op.data_ptr(), rk.numel(), N, span, w,
                            torch.cuda.current_stream().cuda_stream)
                        if code != 0:
                            raise RuntimeError(f"launch failed: {code}")

                    ms = time_ms(run)
                    if not (torch.equal(ok, want[0])
                            and torch.equal(op, want[1])):
                        raise AssertionError(f"{variant} {level}: != plain")
                    totals[name, variant] = totals.get((name, variant),
                                                       0.0) + ms
                    print(f"{name}: level (stride, span, nruns, w)={level} "
                          f"{variant} {ms:.3f} ms, exact", flush=True)
                rk, rp = want
    for (name, variant), ms in totals.items():
        print(f"{name}: all levels {variant} {ms:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
