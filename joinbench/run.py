"""One run of one cell of the port's benchmark.

    python3 -m joinbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root.  The run:

1. installs the port's allocator default (``types.default_alloc_conf``)
   before its first CUDA call, and exits 1, printing no result, without
   as many CUDA devices as the cell asks for;
2. loads the port's kernel library (built into the checkout's
   ``avx_sort_merge_joins_tpu_torch/csrc/build/`` on a first run);
3. makes the cell's relations on the device from the seed (``gen.py``);
4. warms up: two joins on those relations, the only shapes the window
   runs;
5. runs the window: a closed loop with one client, joins back to back on
   the resident relations, each join's answer read to the host before
   the next starts, for ``--seconds``; with ``--trace 1`` under
   ``torch.profiler``;
6. once the window has closed and its peak memory has been read, frees
   the program's state and checks every join's answer against the plain
   reference (``check.py``);
7. exits 3, printing no result, if a module of JAX or of the JAX package
   is loaded;
8. prints the set-up's parts (``[setup]``), the card and its power limit
   (``[device]``), each compared number beside its limit as the last
   lines of standard error, and as the last line of standard output the
   result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
   cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
   ``device``, ``breakdown`` when traced, and ``checks`` last.

``--device cpu`` and ``--tuples`` are for the tests: the program's plain
versions on the CPU at a small size.  The benchmark's own runs never
pass them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "avx_sort_merge_joins_tpu")
WARMUP_JOINS = 2


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads: the cell's sizes and tuple width,
    each window join's info from the entry, and the trace (None untraced
    or off the card)."""

    n_r: int
    n_s: int
    s_pairs: bool  # S goes through the sort with its payloads
    joins: list
    trace: object = None
    key_bytes: int = 4  # bytes a key, and a payload (gen.key_bytes)

    @property
    def n_joins(self) -> int:
        return len(self.joins)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m joinbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="tests only: 'cpu' runs the program's plain "
                        "versions")
    p.add_argument("--tuples", type=int, default=None,
                   help="tests only: |R| instead of the configuration's "
                        "(|S| keeps its ratio to |R|)")
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not load, compared
    whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sizes(config: dict, tuples) -> tuple[int, int]:
    n_r, n_s = int(config["r_tuples"]), int(config["s_tuples"])
    if tuples is None:
        return n_r, n_s
    shards = int(config.get("shards", 1))
    s = max(shards, round(tuples * n_s / n_r) // shards * shards)
    return tuples // shards * shards, s


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def main(argv=None, t0=None, root=None, out=None, err=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    out = out or sys.stdout
    err = err or sys.stderr
    args = parse(argv)
    root = Path(root) if root is not None else spec.default_root()
    cell = spec.load_cell(root, args.workload)
    import torch
    from torch.profiler import record_function

    from avx_sort_merge_joins_tpu_torch import types

    from . import check, gen
    from . import trace as trace_mod

    types.default_alloc_conf()  # before the first CUDA call
    if cell.entry.ANSWER != cell.traffic["query"]:
        raise ValueError(f"{cell.name}: entry answers {cell.entry.ANSWER!r}"
                         f", traffic asks {cell.traffic['query']!r}")
    kb = gen.key_bytes(cell.config, cell.traffic)
    cuda = args.device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"joinbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {found}; no result", file=err)
        return 1
    dev = torch.device("cuda" if cuda else "cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    parts, mark = {}, [t0]

    def lap(name):
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    lap("imports_s")
    if cuda:
        from avx_sort_merge_joins_tpu_torch.kernels import _build

        _build.library()
    lap("library_s")
    torch.empty(1, device=dev)
    sync()
    lap("context_s")
    n_r, n_s = sizes(cell.config, args.tuples)
    rel = gen.make_relations(n_r, n_s, cell.traffic, args.seed, dev,
                             bool(cell.config["payload_columns"]), kb)
    sync()
    lap("data_s")
    state = cell.entry.prepare(rel, cell.config,
                               cell.workload.get("args", {}))
    rowed = cell.entry.ANSWER == "rows"
    positions = check.sample_positions(n_s, args.seed, dev) if rowed \
        else None

    def read(answer):
        got = {"count": int(answer["count"])}
        if "overflow" in answer:
            got["overflow"] = int(answer["overflow"])
        if rowed:
            got["rows"] = check.read_rows(answer["rows"], positions)
        return got

    sync()
    lap("prepare_s")
    for _ in range(WARMUP_JOINS):
        read(cell.entry.join(state)[0])
    sync()
    lap("warmup_s")

    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = contextlib.nullcontext()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
    lat, answers, infos = [], [], []
    kept = None
    with prof:
        t_start = time.perf_counter()  # the profiler has started
        setup_s = t_start - t0
        with record_function(trace_mod.WINDOW):
            while True:
                kept = None  # the last join's rows go before the next join
                t_a = time.perf_counter()
                with record_function("joinbench.join"):
                    answer, info = cell.entry.join(state)
                with record_function("joinbench.result_read"):
                    answers.append(read(answer))
                t_b = time.perf_counter()
                kept = answer.get("rows")
                del answer
                lat.append(t_b - t_a)
                infos.append(info)
                if t_b - t_start >= args.seconds:
                    break
    window_s = t_b - t_start
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    memory_peak = max(setup_peak, window_peak) if cuda else None

    record = Record(n_r, n_s, rowed, infos, key_bytes=kb)
    if args.trace and cuda:
        record.trace = trace_mod.reduce(prof)
    del state, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_r = time.perf_counter()
    checks, failed = check.compare(rel, answers, kept, positions)
    sync()
    parts["reference_s"] = time.perf_counter() - t_r
    del kept, rel

    found = forbidden_modules()
    if found:
        print(f"joinbench: modules a run may not load are loaded: "
              f"{', '.join(found)}; no result", file=err)
        return 3

    e2e = {"join_tput": (n_r + n_s) * len(lat) / window_s / 1e6,
           "join_p95_ms": (statistics.quantiles(
               [x * 1e3 for x in lat], n=20, method="inclusive")[-1]
               if len(lat) > 1 else lat[0] * 1e3),
           "peak_mem_gb": window_peak / 1e9 if cuda else None,
           "setup_s": setup_s}
    metrics = {}
    if not args.trace:
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": cell.chips if cuda else 1,
              "memory_peak_bytes": memory_peak}
    result = {"correct": check.is_correct(checks), "attempted": len(lat),
              "failed": failed, "metrics": metrics, "device": device}
    if args.trace and record.trace is not None:
        device["busy_s"] = record.trace.busy_s
        device["window_s"] = record.trace.window_s
        result["breakdown"] = {
            "device_ops": trace_mod.device_ops(record.trace),
            "idle_gaps": trace_mod.idle_gaps(record.trace)}
    result["checks"] = checks

    parts["setup_s"] = setup_s
    print("[setup] " + json.dumps(parts), file=out)
    print(f"[device] {power_limit() if cuda else 'cpu'}; joins "
          f"{len(lat)} in {window_s} s; window peak {window_peak} B",
          file=out)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
