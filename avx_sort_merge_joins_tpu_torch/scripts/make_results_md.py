"""Render ``RESULTS_TORCH.md`` from the port's grid rows (counterpart of
``scripts/make_results_md.py``; the rows come from
``avx_sort_merge_joins_tpu_torch.scripts.run_results_grid``).

    python -m avx_sort_merge_joins_tpu_torch.scripts.make_results_md \\
        [--src results_grid_torch.jsonl] [--out RESULTS_TORCH.md]

The source defaults to ``SMJ_GRID_OUT`` or ``results_grid_torch.jsonl`` at
the repo root, the output to ``RESULTS_TORCH.md`` there; it never writes
the JAX package's ``RESULTS.md``.  The last row of each key wins (the
runner appends).  The JAX renderer's micro-grid rows and its TPU context
are TPU numbers and are left out: the port's micro-benchmarks are the
script twins' (``scripts/*.sh`` of this package).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .run_results_grid import DEFAULT_OUT, ROOT

DEFAULT_DST = os.path.join(ROOT, "RESULTS_TORCH.md")
JAX_RESULTS = os.path.join(ROOT, "RESULTS.md")  # never written here
M = 1_000_000
ALGOS = ("m-way", "m-pass", "mpsm")
CMD = "python -m avx_sort_merge_joins_tpu_torch.scripts.run_results_grid"


def _fmt_n(n: int) -> str:
    return f"{n // M}M" if n % M == 0 else f"{n:,}"


def load(src: str) -> dict:
    """The rows of ``src`` by key, the last row of each key."""
    by_key = {}
    with open(src) as f:
        for line in f:
            line = line.strip()
            if line:
                row = json.loads(line)
                by_key[row["key"]] = row
    return by_key


def _phase_cols(r) -> str:
    p = r.get("phases_ms")
    if not p:
        return "—"
    order = ["sort", "merge1", "mergerest", "mergejoin", "sort_r", "sort_s",
             "count", "total"]
    parts = [f"{k} {p[k]:.3f}" for k in order if k in p]
    parts += [f"{k} {v:.3f}" for k, v in p.items() if k not in order]
    return ", ".join(parts)


def render(rows: dict) -> str:
    out = []
    w = out.append
    devices = sorted({r.get("device", "?") for r in rows.values()})
    w("# RESULTS_TORCH — the reference's experiment grids on the port\n")
    w("Rendered by `python -m avx_sort_merge_joins_tpu_torch.scripts."
      "make_results_md` from the rows\nof `results_grid_torch.jsonl`.  "
      "Every cell ran once and was asserted `count ==\nexpected` before it "
      "was timed (`exact: true`); times are steady-state ms a run:\none "
      "warm-up run, `burn` untimed runs, then `reps` timed runs between two "
      "CUDA\nevents (the host clock on the CPU).  Mt/s = (|R| + |S|) / "
      "time.\n")
    w("Device: " + "; ".join(f"`{d}`" for d in devices) + "\n")

    w("## 1. Algorithm grid — m-way vs m-pass vs mpsm (tput-scalability.sh "
      "analog, one device)\n")
    w(f"`{CMD} algo`\n")
    w("| algo | n/side | mode | ms/run | Mt/s | phase split (ms, separate "
      "phased run) |")
    w("|---|---|---|---|---|---|")
    algo = sorted((r for r in rows.values() if r["grid"] == "algo"),
                  key=lambda r: (r["nR"], ALGOS.index(r["algo"]), r["mode"],
                                 r.get("nchunks", 1)))
    for r in algo:
        mode = r["mode"]
        if r.get("nchunks", 1) != 1:
            mode += f" (nchunks={r['nchunks']})"
        w(f"| {r['algo']} | {_fmt_n(r['nR'])} | {mode} | {r['ms']:.3f} | "
          f"**{r['mtps']:.1f}** | {_phase_cols(r)} |")
    w("")
    w("`cuda` = the hand-written kernels (K1 + K2 + K3; m-pass K1 + K4 + "
      "K3); `scalar` =\n`torch.sort` and the tagged count (`--scalarsort "
      "--scalarmerge`).  m-pass's scalar\nrow is the m-way's baseline, as "
      "in the JAX grid.\n")

    w("## 2. KEY_8B join (8-byte keys)\n")
    w(f"`{CMD} key8b`\n")
    w("| n/side | ms/run (widen32, sort64 x 2, K7 count) | Mt/s | phase "
      "split (ms) |")
    w("|---|---|---|---|")
    for r in sorted((r for r in rows.values() if r["grid"] == "key8b"),
                    key=lambda r: r["nR"]):
        w(f"| {_fmt_n(r['nR'])} | {r['ms']:.3f} | **{r['mtps']:.1f}** | "
          f"{_phase_cols(r)} |")
    w("")

    w("## 3. Skew — m-way under Zipf S\n")
    w(f"`{CMD} zipf`\n")
    w("| z | n/side | ms/run | Mt/s |")
    w("|---|---|---|---|")
    for r in sorted((r for r in rows.values() if r["grid"] == "zipf"),
                    key=lambda r: r["z"]):
        w(f"| {r['z']} | {_fmt_n(r['nR'])} | {r['ms']:.3f} | "
          f"**{r['mtps']:.1f}** |")
    w("")

    w("## 4. Cardinality — S/R ratio (cardinality.sh analog)\n")
    w(f"`{CMD} card`\n")
    w("| R | S | ratio | ms/run | Mt/s |")
    w("|---|---|---|---|---|")
    for r in sorted((r for r in rows.values() if r["grid"] == "card"),
                    key=lambda r: r["nS"]):
        w(f"| {_fmt_n(r['nR'])} | {_fmt_n(r['nS'])} | {r['ratio']} | "
          f"{r['ms']:.3f} | **{r['mtps']:.1f}** |")
    w("")

    w("## 5. Scalesize — R = S = 32 Mi x k (scalesize.sh analog)\n")
    w(f"`{CMD} scale`\n")
    w("| n/side | ms/run | Mt/s | peak device GB |")
    w("|---|---|---|---|")
    for r in sorted((r for r in rows.values() if r["grid"] == "scale"),
                    key=lambda r: r["nR"]):
        peak = f"{r['peak_gb']:.3f}" if "peak_gb" in r else "not measured"
        w(f"| {r['nR']} | {r['ms']:.3f} | **{r['mtps']:.1f}** | {peak} |")
    w("")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="avx_sort_merge_joins_tpu_torch.scripts.make_results_md")
    p.add_argument("--src", default=os.environ.get("SMJ_GRID_OUT",
                                                   DEFAULT_OUT))
    p.add_argument("--out", default=DEFAULT_DST)
    args = p.parse_args(argv)
    if os.path.realpath(args.out) == os.path.realpath(JAX_RESULTS):
        p.error(f"{args.out} is the JAX package's RESULTS.md")
    md = render(load(args.src))
    with open(args.out, "w") as f:
        f.write(md)
    print(f"wrote {args.out} ({len(md.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
