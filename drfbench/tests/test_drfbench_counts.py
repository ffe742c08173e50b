"""The frozen work counts against hand counts, and the trace reduction on
hand-made intervals."""
import re

import numpy as np
import pytest

from drfbench import counts, tracing

SHAPE = dict(m_num=2, arities=(2, 10000), mode="exact", bins=255, classes=2)


def level(rows, active, cand):
    return dict(rows=np.array(rows), active=np.array(active, bool),
                cand=np.array(cand, bool))


def test_exact_level_by_hand():
    # two siblings of 10 and 6 in-bag rows; node 0's candidates: numeric
    # column 0 and categorical column 3 (arity 10,000); node 1's: the
    # categorical column 2 (arity 2) alone
    lv = level([10, 6], [True, True], [[1, 0, 0, 1], [0, 0, 1, 0]])
    parts = counts.level_parts(lv, **SHAPE)
    assert parts["split_scan"][0] == 10 * (8 + 12) + 8
    # tables from the smaller sibling's 6 rows, each at its own arity
    assert parts["cat_hist"][0] == 6 * (4 + 12) * 2 + (10000 + 2) * 2 * 4
    assert parts["level"][0] == (10 * 8 + 6 * 4 + 6 * 4 + 10 * 12 + 6 * 12
                                 + (10000 + 2) * 2 * 4 + 8)
    # the same column set at the padded arity would count 2 x 10,000 cells
    assert parts["cat_hist"][0] < 6 * 16 * 2 + 2 * 10000 * 2 * 4


def test_hist_level_and_inactive_nodes_by_hand():
    shape = dict(SHAPE, arities=(), m_num=3, mode="hist", bins=255)
    lv = level([100, 40], [True, False], [[1, 1, 0], [1, 1, 1]])
    b, o = counts.level_parts(lv, **shape)["feat_hist"]
    assert b == 40 * (2 * 1 + 12) + 2 * 255 * 2 * 4
    assert o == 40 * 2 * 2


def test_least_time_is_bytes_bound_and_silent_without_work():
    lv = level([1 << 20], [True], [[1, 0, 0, 0]])
    t = counts.least_time([lv], "split_scan", **SHAPE)
    assert t == pytest.approx(((1 << 20) * 20 + 8) / counts.HBM_BYTES_PER_S)
    assert counts.least_time([lv], "cat_hist", **SHAPE) is None


def test_kernel_names_match_the_kernels_and_nothing_else():
    pat = counts.KERNELS
    assert pat["split_scan"].match("void ss_chunk_sums<128>(float const*)")
    assert pat["cat_hist"].match("cat_tile<0, true>(int const*)")
    assert pat["feat_hist"].match("void fh_shared<unsigned char, 0>()")
    for name in ("void at::native::CatArrayBatchedCopy<int>()",
                 "void at::native::vectorized_elementwise_kernel<4>()"):
        assert not any(p.match(name) for p in pat.values())


def test_trace_reduction_on_hand_made_intervals():
    t = tracing.Trace(
        window=(0.0, 100.0), busy=tracing.merge([(10, 20), (15, 30),
                                                 (50, 60)]),
        device_ops={"ss_a": 15.0, "k": 25.0},
        device_spans={"level.numeric": [(10, 30)],
                      "level.hist_tables": [(12, 18)]},
        host_ranges={"level.book": [(25, 55)]},
        idle_by_host={"level.book": 30.0, "-": 30.0})
    assert t.busy == [[10, 30], [50, 60]]
    assert t.busy_s == pytest.approx(30e-6)
    assert t.exposed_s(["level.book"]) == pytest.approx(20e-6)
    assert t.span_s(["level.numeric", "level.hist_tables"]) == \
        pytest.approx(20e-6)
    assert t.span_s(["level.categorical"]) is None
    assert t.kernel_s(re.compile("ss_")) == pytest.approx(15e-6)
    assert tracing.covered(t.busy, 0, 100) == 30


def test_idle_gaps_are_named_by_the_innermost_host_range_and_op():
    host = [(0, 100, "bench.window"), (10, 40, "level.book"),
            (20, 30, "aten::item"), (60, 90, "level.host_fetch")]
    out = tracing._idle_names([(22, 26), (70, 80), (95, 99)], host)
    assert out == {"level.book / aten::item": 4,
                   "level.host_fetch": 10, "bench.window": 4}
