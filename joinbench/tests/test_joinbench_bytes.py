"""The roofline readers: byte counts from the cell's sizes alone, and the
share from the named kernels' device time."""

import pytest

from joinbench import peaks, spec
from joinbench.run import Record
from joinbench.trace import Trace

ROOT = spec.default_root()
ROOFLINES = ("kern.sort_roofline", "kern.merge_roofline")


def _reader(name):
    return spec.load_module(ROOT, "metrics", name)


def _trace(ops):
    return Trace((0, 10**9), ops, [], 10**9)


@pytest.mark.parametrize("name", ROOFLINES)
def test_bytes_depend_on_sizes_only(name):
    b = _reader(name).bytes_per_join
    assert b(128_000_000, 128_000_000, False) == 8 * 256_000_000
    assert b(128_000_000, 128_000_000, True) == 8 * 128_000_000 + 16 * \
        128_000_000
    assert b(1_600_000_000, 1_600_000_000, False) == 8 * 3_200_000_000
    assert b(10, 30, False) == 320


# (|R|, |S|, S in pairs) of the cells, and the bytes a join counted before
# the tuple width came from the configuration: 8 B a key, 16 B a pair
CELL_SHAPES = [(128_000_000, 128_000_000, False, 2_048_000_000),
               (1_600_000_000, 1_600_000_000, False, 25_600_000_000),
               (128_000_000, 128_000_000, True, 3_072_000_000)]


@pytest.mark.parametrize("name", ROOFLINES)
@pytest.mark.parametrize("n_r,n_s,pairs,before", CELL_SHAPES)
def test_bytes_at_the_tuple_width(name, n_r, n_s, pairs, before):
    b = _reader(name).bytes_per_join
    assert b(n_r, n_s, pairs, 4) == b(n_r, n_s, pairs) == before
    assert b(n_r, n_s, pairs, 8) == 2 * before


@pytest.mark.parametrize("name", ROOFLINES)
def test_share_reads_the_records_tuple_width(name):
    ops = [("void block_sort_kernel<16384>(int)", 0, 10**6),
           ("void merge_kernel<int, 4096>(Runs)", 0, 10**6)]
    shares = []
    for kb in (4, 8):
        rec = Record(1_000_000, 1_000_000, False, [{}] * 2, key_bytes=kb)
        rec.trace = _trace(ops)
        shares.append(_reader(name).read(rec))
    assert shares[1] == pytest.approx(2 * shares[0])


@pytest.mark.parametrize("name,kernels", [
    ("kern.sort_roofline", ["void (anonymous namespace)::block_sort_kernel"
                            "<16384>(int const*, int*, long long)",
                            "void block_sort_pairs_kernel<16384>(int)"]),
    ("kern.merge_roofline", ["void (anonymous namespace)::merge_kernel<int, "
                             "4096>(Runs)", "corank_kernel(Runs)",
                             "gate_kernel(int const*)",
                             "void (anonymous namespace)::merge_pass_kernel"
                             "<int, false, UniformRuns>(int const*)"])])
def test_share_is_bytes_over_peak_over_kernel_time(name, kernels):
    reader = _reader(name)
    others = [("void radix_hist_kernel(int const*)", 0, 7 * 10**6),
              ("merge_join_count_kernel(int)", 0, 5 * 10**6),
              ("remote_pull_kernel(Args)", 0, 3 * 10**6)]
    # the same kernel time split over one level or over four: one share
    one = [(kernels[0], 0, 4 * 10**6)] + others
    four = [(k, 0, 10**6) for k in (kernels * 4)[:4]] + others
    rec = Record(1_000_000, 2_000_000, False, [{}] * 3)
    rec.trace = _trace(one)
    a = reader.read(rec)
    rec.trace = _trace(four)
    b = reader.read(rec)
    want = 100 * 8 * 3_000_000 * 3 / peaks.HBM_BYTES_PER_S / 4e-3
    assert a == pytest.approx(want) and b == pytest.approx(want)


@pytest.mark.parametrize("name", ROOFLINES)
def test_no_kernel_no_trace_reads_nothing(name):
    rec = Record(10, 10, False, [{}])
    assert _reader(name).read(rec) is None
    rec.trace = _trace([("aten::copy_", 0, 100)])
    assert _reader(name).read(rec) is None
