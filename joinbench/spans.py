"""What the readers of the program's spans and counters read: the registry
of ``avx_sort_merge_joins_tpu_torch.utils.profiling`` (``span_totals``),
in the harness's process after the window.  The program records into it
only while a profiler records, and a run starts its profiler for the
window alone (the warm-up joins and the check run untraced), so the
registry holds the window's joins.  Each reader gives None where the
registry has nothing under its names: an untraced run, or a program
without the registry."""


def totals() -> dict:
    """The registry by name, or empty where the program has none."""
    from avx_sort_merge_joins_tpu_torch.utils import profiling

    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else {}


def calls_per_join(run, name: str):
    """A counter's count (a span's calls) over the window's joins."""
    t = totals().get(name)
    if t is None or not t.calls or not run.n_joins:
        return None
    return t.calls / run.n_joins


def device_ms_per_join(run, *names: str):
    """The summed device milliseconds of the spans ``names`` over the
    window's joins."""
    found = [t for name, t in totals().items() if name in names]
    if not found or not run.n_joins:
        return None
    return 1e3 * sum(t.device_s for t in found) / run.n_joins
