"""Command-line entry point of the port (counterpart of
``avx_sort_merge_joins_tpu/cli.py:19-114,156-206,209-341,373-466``;
reference: src/main.c): the same flags, the same workload construction and
the same output conventions -- ``Results = N`` on stdout,
``[STATS]``/``[RECORD]``/``[ROOFLINE]`` on stderr so scripts can split the
streams (joincommon.c:175-196).

Ported: the single-device count joins ``-a m-way|m-pass|mpsm -n 1 -r -s
-x -y -z -f --nchunks --scalarsort --scalarmerge --non-unique
--full-range``, the materializing m-way join (``--materialize``),
``--persist DIR``, the 64-bit-key count join (``--key8b``; with ``-n N``
it runs on one device as the JAX CLI does, after the fan-out is raised to
N), and on a mesh of N shards (``parallel/``) the distributed count joins
``-a m-way -n N -S NEXT|RING|RANDOM``, ``-a m-pass -n N`` and ``-a mpsm -n
N``, and the distributed materializing join ``-n N --materialize
[--persist DIR]`` (for any ``-a``, with a warning when it is not m-way, as
in the JAX CLI; ``--persist`` streams Out.tbl a shard at a time).  The
mesh is N shards of the relations' device, or, with ``--mapping-file F``
(format ``NDEV id0 ... id{NDEV-1} [#HOSTS]``, the JAX CLI's), shard i on
``cuda:<id i>`` (every id names the CPU under ``--device cpu``); the
trailing host count sets the RING schedule's stride.  As in the JAX CLI
the file shapes only the mesh of a ``-n N`` run.  A file with fewer ids
than ``-n``, or an id past the card count, exits 2 with the reason.

The workload-A scale tier (``parallel/scale.py``): with ``-n N > 1`` and
``max(-r, -s) >= SMJ_SHARDED_GEN_MIN`` (default 500,000,000), sizes that
divide by N and none of ``--non-unique``, ``--full-range``,
``--materialize``, ``--key8b``, each shard's columns are made on the
device and joined by the pre-sharded distributed m-way
(``SMJ_SCALE_PHASED=1``, the default, through its phased entry point; 0
through the fused one).  Asked for another ``-a``, ``--scalarsort``,
``--scalarmerge`` or ``-S``, it warns and takes the standard path.  Its
mesh is N shards of one card, or the mapping file's cards.

The single-device joins print ``[ROOFLINE]`` rows after ``[RECORD]``:
each phase's bytes over its time, against the copy rate measured on the
join's device (``SMJ_HBM_GBPS`` overrides it).  ``-o DIR`` writes a
``torch.profiler`` trace of the run to ``DIR/trace.json``.  ``-m BYTES``
sizes the K2 merge tile of the single-device m-way join
(``multiwaymerge.merge_tile_for``: 2,048, 4,096 or 8,192 outputs; the
count does not change); with ``-n N > 1`` it warns and is ignored, as in
the JAX CLI.  Sizes a path does not take are refused up front with exit code 1 (``_size_refusal``: |R|
past 2^31 - 2, whose keys would reach the pad; a relation past 2^31 - 1
tuples anywhere but the one-device m-way count join's kernels); a run
past the device's memory exits 1 with the error.  Relations and
kernels run on the card (``--device cuda``, the
default; without a card the CLI exits 1).  ``--device cpu`` runs them on
the CPU through the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

NOT_PORTED_EXIT = 2
NO_DEVICE_EXIT = 1
OVERFLOW_EXIT = 1  # the distributed exchange overflowed (cli.py:278-281)
TOO_LARGE_EXIT = 1  # a size past what the run's path takes
OUT_OF_MEMORY_EXIT = 1  # the device ran out of memory
# R's keys are drawn from 1..|R| (0..|R| - 1 with --non-unique): they
# must stay below the INT32_MAX pad.
MAX_R = 2**31 - 2
# Past INT_MAX = 2^31 - 1 tuples a relation runs only where that was
# checked exact on the card: the one-device m-way count join's kernel
# route (cardinality.sh's last row at its default NR asks for |S| = 2^31;
# torch.sort, which the scalar routes and others take, stops at INT_MAX).
INT_MAX = 2**31 - 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="avx_sort_merge_joins_tpu_torch",
        description="sort-merge joins on PyTorch and hand-written CUDA "
                    "kernels")
    # flag set mirrors main.c:722-745
    p.add_argument("-a", "--algo", default="m-way",
                   choices=["m-way", "m-pass", "mpsm"],
                   help="join algorithm")
    p.add_argument("-n", "--nthreads", type=int, default=1,
                   help="shards of the mesh; past 1 the distributed "
                        "join runs N shards on one device")
    p.add_argument("-r", "--r-size", type=int, default=128_000_000)
    p.add_argument("-s", "--s-size", type=int, default=128_000_000)
    p.add_argument("-x", "--r-seed", type=int, default=12345)
    p.add_argument("-y", "--s-seed", type=int, default=54321)
    p.add_argument("-z", "--skew", type=float, default=0.0,
                   help="Zipf skew parameter for S")
    p.add_argument("--non-unique", action="store_true",
                   help="R keys drawn uniformly instead of unique 1..|R|")
    p.add_argument("--full-range", action="store_true",
                   help="R keys span the full 2^31 domain (KEY_8B analog)")
    p.add_argument("--scalarsort", action="store_true",
                   help="use the torch.sort baseline for sorting")
    p.add_argument("--scalarmerge", action="store_true",
                   help="use the torch.sort baseline for merging/counting")
    p.add_argument("-f", "--partfanout", type=int, default=None,
                   help="multiway merge fan-in (reference PARTFANOUT): "
                        "every merge level greedily at it; default: each "
                        "sort's planned levels, fan-ins up to 32 (KEY_8B: "
                        "16)")
    p.add_argument("-S", "--numastrategy", default="NEXT",
                   choices=["NEXT", "RING", "RANDOM"],
                   help="exchange schedule of the multi-shard shuffle")
    p.add_argument("-m", "--mwaybufsize", type=int, default=0,
                   help="multiway merge buffer size in bytes: sizes the "
                        "m-way's K2 merge tile (0: derived)")
    p.add_argument("--nchunks", type=int, default=1,
                   help="mpsm: number of local S runs")
    p.add_argument("--materialize", action="store_true",
                   help="produce join output tuples, not only the count "
                        "(m-way; with -n N for any -a)")
    p.add_argument("--persist", metavar="DIR", default=None,
                   help="write R.tbl/S.tbl/Out.tbl (generator.c:200-213)")
    p.add_argument("--key8b", action="store_true",
                   help="64-bit keys (the KEY_8B build): the count join over "
                        "(hi, lo) key planes; ignores -a")
    p.add_argument("-o", "--perfout", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json (the PCM perf-counter output "
                        "analog, main.c:738)")
    p.add_argument("-p", "--perfconf", default=None,
                   help="accepted for flag parity (PCM event config)")
    p.add_argument("--mapping-file", default=None,
                   help="device mapping file (cpu-mapping.txt analog): "
                        "'NDEV id0 .. id{NDEV-1} [#HOSTS]', shard i of a "
                        "-n N mesh on cuda:<id i>")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where relations and kernels run: the card, or "
                        "the CPU through the kernels' plain PyTorch "
                        "versions")
    p.add_argument("--verbose", action="store_true")
    return p


def make_relations(args, device):
    """Workload construction, mirroring main.c:534-588:

    default      R = parallel_create_relation(|R|, maxid=|R|)   (unique)
                 S = parallel_create_relation(|S|, maxid=|R|)   (uniform fk)
                     or create_relation_zipf(|S|, |R|, z) under --skew
    --non-unique R, S = create_relation_nonunique(size, |R|)
    --full-range R = create_relation_nonunique(|R|, INT_MAX)
                 S = create_relation_fk_from_pk(R, |S|)
    """
    from . import datagen
    from .utils.log import info

    datagen.seed_generator(args.r_seed)
    if args.full_range:
        info(f"Creating full-range R with {args.r_size} tuples")
        R = datagen.create_relation_nonunique(args.r_size, 2**31 - 1,
                                              device=device)
    elif args.non_unique:
        info(f"Creating non-unique R with {args.r_size} tuples")
        R = datagen.create_relation_nonunique(args.r_size, args.r_size,
                                              device=device)
    else:
        info(f"Creating unique R with {args.r_size} tuples")
        R = datagen.parallel_create_relation(args.r_size, args.r_size,
                                             args.nthreads, device=device)
    datagen.seed_generator(args.s_seed)
    if args.full_range:
        info(f"Creating fk-from-pk S with {args.s_size} tuples")
        S = datagen.create_relation_fk_from_pk(R, args.s_size, device=device)
    elif args.non_unique:
        info(f"Creating non-unique S with {args.s_size} tuples")
        S = datagen.create_relation_nonunique(args.s_size, args.r_size,
                                              device=device)
    elif args.skew > 0:
        info(f"Creating Zipf S with {args.s_size} tuples, z={args.skew}")
        S = datagen.create_relation_zipf(args.s_size, args.r_size, args.skew,
                                         device=device)
    else:
        info(f"Creating uniform fk S with {args.s_size} tuples")
        S = datagen.parallel_create_relation(args.s_size, args.r_size,
                                             args.nthreads, device=device)
    return R, S


class BucketOverflow(Exception):
    """The distributed exchange overflowed its buckets at the largest
    slack: the count would not be exact."""


def _run_dist_mway(args, R, S, mesh):
    """``-a m-way -n N``: the distributed m-way count join, through the
    phased entry point so that the record row gets SORT / MERGE1 / MJOIN
    columns (the JAX CLI, cli.py:221-262)."""
    from .parallel import dist_mway
    from .types import JoinResult
    from .utils.log import info

    xpath = ("bulk all_to_all" if args.numastrategy == "NEXT" else
             f"{args.numastrategy}-scheduled collective_permute rounds")
    info(f"exchange path: {xpath}, a device-side copy between the "
         f"{mesh.n} shards on one device ({mesh.device}), not an "
         "interconnect")
    cnt, overflow, phases = dist_mway.dist_mway_join_phased(
        R.keys, S.keys, R.num_tuples, S.num_tuples, mesh,
        fanin=args.partfanout, use_kernels=_use_kernels(args),
        numa_strategy=(args.numastrategy if args.numastrategy != "NEXT"
                       else None))
    _check_overflow(overflow)
    total = phases["total"]
    return JoinResult(totalresults=cnt, resultlist=[], phases=phases,
                      throughput=(R.num_tuples + S.num_tuples) / total
                      if total > 0 else 0.0)


def _use_kernels(args) -> bool:
    """``--scalarsort``/``--scalarmerge`` select the ``torch.sort``
    baseline route of a distributed join (the JAX CLI's
    ``use_pallas=False``)."""
    return not (args.scalarsort or args.scalarmerge)


def _check_overflow(overflow: int) -> None:
    if overflow:
        raise BucketOverflow(f"exchange bucket overflow ({overflow} "
                             "tuples); raise slack")


def _run_dist_materialize(args, R, S, mesh):
    """``-n N --materialize``: the distributed materializing join.  Under
    ``--persist DIR`` the output streams into DIR/Out.tbl a shard at a
    time, and the result carries no relation (the JAX CLI, cli.py:117-153).
    """
    import os

    from .parallel import dist_materialize
    from .types import JoinResult, Relation, ThreadResult
    from .utils.log import info

    stream_to = None
    if args.persist:
        os.makedirs(args.persist, exist_ok=True)
        stream_to = os.path.join(args.persist, "Out.tbl")
    t0 = time.perf_counter()
    ks, ps, cnt, overflow = dist_materialize.dist_join_materialize(
        R.keys, R.payloads, S.keys, S.payloads, R.num_tuples, S.num_tuples,
        mesh, stream_to=stream_to)
    dt = time.perf_counter() - t0
    _check_overflow(overflow)
    results = []
    if stream_to is not None:
        info(f"streamed {cnt} output tuples to {stream_to}")
    else:
        results = [ThreadResult(nresults=cnt, shard_id=0,
                                results=Relation(ks, ps, cnt))]
    return JoinResult(totalresults=cnt, resultlist=results,
                      phases={"total": dt},
                      throughput=(R.num_tuples + S.num_tuples) / dt)


def _run_dist(args, R, S):
    """``-n N``: a distributed join on a mesh of N shards on the relations'
    device, or on the mapping file's devices, routed as the JAX CLI routes
    it (cli.py:209-281): mpsm takes
    the ``-f`` fan-in and m-pass none; ``--scalarsort``/``--scalarmerge``
    select the baseline route of each count join, and the materializing
    join takes neither flag.  Each but m-way reports one ``total``
    phase."""
    from .types import JoinResult
    from .utils.log import warn

    mesh = _make_mesh(args, R.keys.device)
    if args.materialize:
        if args.algo != "m-way":
            warn("--materialize with -n>1 uses the distributed m-way "
                 "pipeline")
        return _run_dist_materialize(args, R, S, mesh)
    if args.algo == "m-way":
        return _run_dist_mway(args, R, S, mesh)
    t0 = time.perf_counter()
    if args.algo == "mpsm":
        from .parallel import dist_mpsm
        cnt, overflow = dist_mpsm.dist_mpsm_join_count(
            R.keys, S.keys, R.num_tuples, S.num_tuples, mesh,
            fanin=args.partfanout, use_kernels=_use_kernels(args))
    else:
        from .parallel import dist_mpass
        cnt, overflow = dist_mpass.dist_mpass_join_count(
            R.keys, S.keys, R.num_tuples, S.num_tuples, mesh,
            use_kernels=_use_kernels(args))
    dt = time.perf_counter() - t0
    _check_overflow(overflow)
    return JoinResult(totalresults=cnt, resultlist=[], phases={"total": dt},
                      throughput=(R.num_tuples + S.num_tuples) / dt)


def run_join(args, R, S):
    from .types import JoinConfig

    if args.nthreads > 1:
        return _run_dist(args, R, S)

    config = JoinConfig(
        nthreads=args.nthreads,
        scalar_sort=args.scalarsort,
        scalar_merge=args.scalarmerge,
        mwaybufsize_bytes=args.mwaybufsize,
        materialize=args.materialize,
    )
    if args.algo == "m-pass":
        from .models.mpass import sortmergejoin_multipass
        return sortmergejoin_multipass(R, S, config)
    if args.algo == "mpsm":
        from .models.mpsm import sortmergejoin_mpsm
        return sortmergejoin_mpsm(R, S, config, nchunks=args.nchunks)
    from .models.mway import sortmergejoin_multiway
    if args.mwaybufsize:
        from .ops.multiwaymerge import merge_tile_for
        from .utils.log import info

        fanin = ("the planned fan-ins" if args.partfanout is None
                 else f"fan-in {args.partfanout}")
        info(f"-m {args.mwaybufsize}: K2 merge tile "
             f"{merge_tile_for(args.mwaybufsize, args.partfanout)} outputs "
             f"at {fanin}")
    return sortmergejoin_multiway(R, S, config, fanin=args.partfanout)


def _run_key8b(args, R, S):
    """KEY_8B (64-bit-key, 16-byte-tuple) count join of the same seeded
    relations, their keys widened to (hi, lo) int32 planes (the reference's
    KEY_8B stores the same key values in 64-bit storage, types.h:23-29):
    both sides sorted by the pair multiway sort (K5 + K6) and counted by
    K7.  ``--scalarsort``/``--scalarmerge`` take the ``torch.sort`` route
    end to end (the reference's only working KEY_8B path, main.c:871-877).
    The timed window ends after the count is read back."""
    from .ops import join64
    from .types import JoinResult

    nR, nS = R.num_tuples, S.num_tuples
    t0 = time.perf_counter()
    named = {} if args.partfanout is None else {"fanin": args.partfanout}
    _, _, count = join64.key8b_join_count(
        R.keys, S.keys, nR, nS,
        pallas_sort=not (args.scalarsort or args.scalarmerge), **named)
    cnt = join64.finish_count64(count)
    dt = time.perf_counter() - t0
    return JoinResult(totalresults=cnt, resultlist=[], phases={"total": dt},
                      throughput=(nR + nS) / dt)


def _validate(args) -> str | None:
    """Parameter checks of the JAX CLI's ``_validate`` (cli.py:344-370,
    after main.c:860-886): the error that refuses this run, if any."""
    from .ops.multiwaymerge import greedy_fanin
    from .utils.log import warn

    fanin = args.partfanout
    if fanin is not None and (fanin < 2 or fanin & (fanin - 1)):
        return "partfanout must be a power of 2"
    if args.nchunks < 1:
        return "--nchunks must be >= 1"
    if args.nthreads < 1:
        return f"-n {args.nthreads}: need at least one shard"
    if args.nthreads > 1 and greedy_fanin(fanin) < args.nthreads:
        # the reference requires fanout >= nthreads (main.c:866-869); with
        # no -f the received runs merge at greedy_fanin's 16
        warn("raising partfanout to the shard count")
        args.partfanout = 1 << (args.nthreads - 1).bit_length()
    if args.materialize and args.algo != "m-way" and not args.key8b \
            and args.nthreads == 1:
        return ("--materialize: the JAX package materializes on m-way only "
                f"(its {args.algo} join ignores the flag)")
    if args.nchunks != 1 and (args.algo != "mpsm" or args.nthreads > 1):
        warn("--nchunks applies to single-device mpsm only")
    if args.mwaybufsize and args.nthreads > 1:
        # the JAX CLI's warning (cli.py:231-234): the flag is ignored
        warn("-m merge-buffer size has no effect on the distributed path "
             "(its merge tiles are fixed)")
    if args.mapping_file is not None:
        return _mapping_refusal(args)
    return None


def _mapping_refusal(args) -> str | None:
    """Why the mapping file cannot shape this run's mesh, if it cannot: a
    file that does not read as ``NDEV id0 ... [#HOSTS]``, or holds fewer
    ids than ``-n``."""
    from .parallel.mesh import read_mapping_file

    try:
        ids, _ = read_mapping_file(args.mapping_file)
    except (OSError, ValueError) as e:
        return (f"--mapping-file {args.mapping_file}: not 'NDEV id0 .. "
                f"id{{NDEV-1}} [#HOSTS]' ({e})")
    if len(ids) < args.nthreads:
        return (f"--mapping-file {args.mapping_file}: {len(ids)} device ids "
                f"for -n {args.nthreads} shards")
    return None


def _make_mesh(args, device):
    """The ``-n N`` mesh: the installed mapping file's first N devices, or
    N shards of ``device``."""
    from .parallel import mesh as mesh_mod

    return mesh_mod.make_mesh(
        args.nthreads, None if mesh_mod.DEFAULT_MESH else device)


SCALE_MIN_DEFAULT = 500_000_000  # SMJ_SHARDED_GEN_MIN's default


def _size_refusal(args, scale_tier: bool) -> str | None:
    """Why this run's sizes do not fit its path, if they do not: R's keys
    must stay below the pad (``MAX_R``), and on the standard path a
    relation past ``INT_MAX`` tuples takes only the one-device m-way count
    join's kernel route."""
    if args.r_size > MAX_R:
        return (f"-r {args.r_size}: R's keys 1..|R| must stay below the "
                f"INT32_MAX pad: |R| <= {MAX_R}")
    big = max(args.r_size, args.s_size) > INT_MAX
    mway_kernels = (args.algo == "m-way" and args.nthreads == 1
                    and not (args.scalarsort or args.scalarmerge
                             or args.materialize or args.key8b))
    if big and not (scale_tier or mway_kernels):
        return (f"-s {args.s_size}: past {INT_MAX} tuples a relation runs "
                "on one device only through the m-way count join's "
                "kernels (-a m-way -n 1, no --scalarsort, --scalarmerge, "
                "--materialize or --key8b)")
    return None


def _scale_eligible(args) -> bool:
    """Whether this run takes the workload-A scale tier (the JAX CLI's
    routing, cli.py:400-425): a warning, and the standard path, where the
    tier would fit but the flags ask for what it does not run."""
    from .utils.log import warn

    scale_min = int(os.environ.get("SMJ_SHARDED_GEN_MIN", SCALE_MIN_DEFAULT))
    eligible = (
        args.nthreads > 1 and max(args.r_size, args.s_size) >= scale_min
        and not (args.non_unique or args.full_range or args.materialize
                 or args.key8b)
        and args.r_size % args.nthreads == 0
        and args.s_size % args.nthreads == 0)
    if eligible and (args.algo != "m-way" or args.scalarsort
                     or args.scalarmerge or args.numastrategy != "NEXT"):
        # the tier runs the m-way pipeline with the default exchange only:
        # never report its numbers for another algorithm or variant
        warn(f"scale tier (>= {scale_min} tuples) supports -a m-way with "
             "default sort/merge/schedule only; running the standard "
             f"{args.algo} path (relations built whole -- may exhaust "
             "memory at this size)")
        return False
    return eligible


def _run_scale_tier(args, device, dname: str) -> int:
    """Workload A: each shard's columns made on the device, then the
    pre-sharded distributed m-way count join (``parallel/scale.py``; the
    1.6B ⋈ 1.6B configuration, tput-scalability.sh:15-16).  Generation is
    set-up, timed apart; the slack is 4.0 under ``-z`` and 2.0 otherwise
    (cli.py:187), and the one the run ended at is printed."""
    import torch

    from .models.common import device_sync
    from .parallel import dist_mway, scale
    from .utils import profiling
    from .utils.log import error, info

    mesh = _make_mesh(args, device)
    where = (f"one device ({dname})" if not mesh.per_shard else
             f"{', '.join(str(d) for d in mesh.devices)}")
    info(f"scale tier: sharded on-device generation of "
         f"{args.r_size}⋈{args.s_size} over {args.nthreads} shards of "
         f"{where}")
    t0 = time.perf_counter()
    rk, sk = scale.make_workload_a_sharded(
        args.r_size, args.s_size, mesh, seed=args.r_seed, skew=args.skew,
        s_seed=args.s_seed)
    device_sync(sk)
    info(f"relations ready in {time.perf_counter() - t0:.3f} s")
    # the phased entry point gives the [RECORD] row SORT / MERGE1 / MJOIN
    # columns at the cost of three device syncs, which the fused one does
    # not make; SMJ_SCALE_PHASED=0 runs the fused one, whose row has the
    # total only
    phased = os.environ.get("SMJ_SCALE_PHASED", "1") == "1"
    t0 = time.perf_counter()
    with torch.profiler.record_function("join"):
        out = scale.join_sharded(rk, sk, args.r_size, args.s_size, mesh,
                                 fanin=args.partfanout,
                                 slack=4.0 if args.skew > 0 else 2.0,
                                 phased=phased)
    dt = time.perf_counter() - t0
    cnt, overflow = out[:2]
    phases = out[2] if phased else {"total": dt}
    peak = ""
    if device.type == "cuda":  # since _run began
        gb = torch.cuda.max_memory_allocated(device) / 1e9
        peak = f", peak device memory {gb:.3f} GB"
    info(f"scale tier: slack {dist_mway.LAST_SLACK}, overflow {overflow}"
         + peak)
    if overflow:
        error(f"exchange bucket overflow ({overflow})")
        return OVERFLOW_EXIT
    nt = args.r_size + args.s_size
    print(f"[STATS] NUMTUPLES {nt}, TOTAL-TIME-USECS {dt*1e6:.1f}, "
          f"TUPLES-PER-SECOND {nt/dt:.0f}, DEVICE {dname}", file=sys.stderr)
    print(profiling.record_line(args.algo, args.nthreads, args.r_size,
                                args.s_size, 0, phases, dname),
          file=sys.stderr)
    print(f"Results = {cnt}")
    return 0


def _run(args, device, dname: str) -> int:
    """Build the relations and run the join the flags name; print the
    statistics and the result."""
    import torch

    from .models.common import device_sync
    from .utils import profiling
    from .utils.log import error, info

    scale_tier = _scale_eligible(args)
    too_large = _size_refusal(args, scale_tier)
    if too_large:
        error(too_large)
        return TOO_LARGE_EXIT
    if device.type == "cuda":  # the peak printed below is this run's
        torch.cuda.reset_peak_memory_stats(device)
    if scale_tier:
        return _run_scale_tier(args, device, dname)
    t0 = time.perf_counter()
    R, S = make_relations(args, device)
    # data generation is set-up, not a join phase
    device_sync((R.keys, S.keys))
    info(f"relations ready in {time.perf_counter() - t0:.3f} s")
    ntotal = R.num_tuples + S.num_tuples
    if args.key8b:
        result = _run_key8b(args, R, S)
        print(f"[STATS] NUMTUPLES {ntotal}, TUPLES-PER-SECOND "
              f"{result.throughput:.0f}, DEVICE {dname}", file=sys.stderr)
        print(f"Results = {result.totalresults}")
        return 0
    try:
        with torch.profiler.record_function("join"):
            result = run_join(args, R, S)
    except BucketOverflow as e:
        error(str(e))
        return OVERFLOW_EXIT
    # statistics to stderr, results to stdout (joincommon.c:175-196 split)
    for name, secs in result.phases.items():
        print(f"[STATS] {name:12s} {secs * 1e6:12.1f} usecs", file=sys.stderr)
    total = result.phases.get("total", 0.0) or 1e-12
    print(f"[STATS] NUMTUPLES {ntotal}, TOTAL-TIME-USECS {total*1e6:.1f}, "
          f"TUPLES-PER-SECOND {result.throughput:.0f}, DEVICE {dname}",
          file=sys.stderr)
    print(profiling.record_line(args.algo, args.nthreads, R.num_tuples,
                                S.num_tuples, 0, result.phases, dname),
          file=sys.stderr)
    if device.type == "cuda":  # since _run began
        info(f"peak device memory "
             f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB")
    if result.bytes_moved:
        # %-of-roofline a phase (cli.py:451-455), against this device's
        # own copy rate
        gbps, origin = profiling.hbm_gbps(device)
        report = profiling.BytesMoved(dict(result.bytes_moved)) \
            .roofline_report(result.phases, gbps)
        if report:
            print(f"[ROOFLINE] denominator {gbps:.1f} GB/s: {origin} "
                  f"({dname})", file=sys.stderr)
            print(report, file=sys.stderr)
    print(f"Results = {result.totalresults}")
    if args.persist:
        from .datagen import write_relation

        os.makedirs(args.persist, exist_ok=True)
        write_relation(R, os.path.join(args.persist, "R.tbl"))
        write_relation(S, os.path.join(args.persist, "S.tbl"))
        if args.materialize and result.resultlist:
            write_relation(result.resultlist[0].results,
                           os.path.join(args.persist, "Out.tbl"))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.log import error, info

    bad = _validate(args)
    if bad:
        error(bad)
        return NOT_PORTED_EXIT

    import torch

    from .parallel import mesh as mesh_mod
    from .types import default_device, device_name

    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        try:
            device = default_device()
        except RuntimeError as e:
            error(str(e))
            return NO_DEVICE_EXIT
    # --mapping-file: the file's mesh installed as the DEFAULT_MESH that the
    # -n N routes build their mesh from, as the JAX CLI installs it
    # (cli.py:390-394), and the module state restored after the run
    saved = mesh_mod.DEFAULT_MESH, mesh_mod.HOST_GRANULARITY
    try:
        if args.mapping_file is not None:
            try:
                mesh_mod.DEFAULT_MESH = mesh_mod.mesh_from_mapping_file(
                    args.mapping_file, device.type)
            except ValueError as e:  # an id past the card count
                error(str(e))
                return NOT_PORTED_EXIT
        dname = device_name(device)
        info(f"device: {dname}" if device.type == "cuda"
             else "device: cpu (plain PyTorch versions)")
        return _run_traced(args, device, dname)
    finally:
        mesh_mod.DEFAULT_MESH, mesh_mod.HOST_GRANULARITY = saved


def _run_traced(args, device, dname: str) -> int:
    """:func:`_run`, under the profiler with ``-o DIR``; a run past the
    device's memory exits 1."""
    import torch

    from .utils import profiling
    from .utils.log import error, info

    # -o: the whole run, generation included, under the profiler
    # (cli.py:395-399, :421-437)
    traced = (profiling.trace(args.perfout, device) if args.perfout
              else contextlib.nullcontext())
    with traced:
        try:
            rc = _run(args, device, dname)
        except torch.OutOfMemoryError as e:
            # past the card's memory (scalesize.sh's 60 x 32 Mi row on an
            # 80 GB card): no result, exit 1
            error(f"out of device memory at -r {args.r_size} -s "
                  f"{args.s_size} -n {args.nthreads}: "
                  f"{str(e).splitlines()[0]}")
            return OUT_OF_MEMORY_EXIT
    if args.perfout:
        info(f"trace written to "
             f"{os.path.join(args.perfout, profiling.TRACE_FILE)}")
    return rc


if __name__ == "__main__":
    from .types import default_alloc_conf

    default_alloc_conf()  # before the first CUDA call
    sys.exit(main())
