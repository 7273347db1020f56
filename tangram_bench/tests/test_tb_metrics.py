"""The metric arithmetic: every statistic is one figure over the whole
window; misses count as infinite; a rate is all work over all time."""
import math

import numpy as np
import pytest
from tb_fixtures import tiny_config, tiny_traffic

from tangram_bench import counters, harness, stats
from tangram_bench.trace import TraceData, idle_gaps, union_length


def inv(t0, t1, routed, patches, canvases=1, used=None, records=None):
    return harness.InvRec(
        t0, t1, patches, canvases, used or [0] * canvases,
        records if records is not None else np.zeros((canvases, 1, 6),
                                                      np.int32),
        t_routed=routed)


def run(mode, invs=(), patches=(), seconds=10.0, slo=0.5, trace=None):
    cfg = tiny_config()
    return harness.RunData(seconds, slo, mode, cfg, tiny_traffic(mode),
                           list(invs), list(patches), [], trace)


def test_nearest_rank_percentile():
    assert stats.nearest_rank(range(1, 101), 0.95) == 95
    assert stats.nearest_rank([3.0], 0.95) == 3.0
    assert stats.nearest_rank([1, 2, 3, 4], 0.5) == 2


def test_p95_counts_every_patch_and_misses_as_infinite():
    read = harness.load_reader("patch_latency_p95_ms")
    # 100 patches captured in the window: 94 routed 0.1 s after capture,
    # one at 0.3 s, five never routed -> the 95th is the slowest routed
    pts = [(i * 0.05, i * 0.05 + 0.1) for i in range(94)]
    pts.append((5.0, 5.3))
    pts += [(6.0, None)] * 5
    assert read(run("live", patches=pts)) == pytest.approx(300.0)
    # a sixth miss moves the 95th onto a miss: the longest latency measured
    pts2 = pts[:-6] + [(6.0, None)] * 6 + [(1.0, 1.2)]
    assert math.isinf(stats.nearest_rank(
        stats.latencies(run("live", patches=pts2)), 0.95))
    assert read(run("live", patches=pts2)) == pytest.approx(200.0)
    # captured after the window: not counted; routed after window + SLO:
    # a miss
    r = run("live", patches=[(10.5, 10.6), (9.0, 10.6)], seconds=10.0)
    assert stats.latencies(r) == [math.inf]


def test_patches_per_s_is_all_work_over_all_time():
    read = harness.load_reader("patches_per_s")
    invs = [inv(0.0, 0.1, 1.0, 30), inv(1.0, 1.1, 9.9, 40),
            inv(9.5, 9.6, 10.2, 50), inv(2.0, 2.1, None, 10)]
    assert read(run("replay", invs)) == pytest.approx(70 / 10.0)
    assert read(run("live", invs)) is None


def test_billed_ms_per_kpatch():
    read = harness.load_reader("billed_ms_per_kpatch")
    invs = [inv(0.0, 0.1, 0.25, 20), inv(1.0, 1.1, 1.5, 30),
            inv(10.5, 10.6, 11.0, 99)]
    # (0.25 + 0.5) s = 750 ms over 50 patches -> 15,000 ms a kpatch
    assert read(run("live", invs)) == pytest.approx(15000.0)


def test_slo_miss_and_canvas_fill():
    miss = harness.load_reader("slo_miss_pct.live")
    pts = [(0.0, 0.4)] * 3 + [(0.0, 0.6), (1.0, None)]
    assert miss(run("live", patches=pts)) == pytest.approx(40.0)
    fill = harness.load_reader("canvas_fill_pct.live")
    area = 128 * 128
    invs = [inv(0, 0.1, 1, 3, 2, [area // 2, area // 4]),
            inv(20, 20.1, 21, 3, 1, [area])]          # after the window
    assert fill(run("live", invs)) == pytest.approx(37.5)


def test_staging_per_canvas_over_the_window():
    read = harness.load_reader("staging_ms_per_canvas.replay")
    invs = [inv(0.0, 0.2, 1, 10, 8), inv(1.0, 1.1, 2, 5, 2),
            inv(12.0, 13.0, 14, 5, 8)]
    assert read(run("replay", invs)) == pytest.approx(300.0 / 10)
    assert harness.load_reader("staging_ms_per_canvas.live")(
        run("replay", invs)) is None


def test_mfu_counts_canvases_routed_in_the_window():
    read = harness.load_reader("mfu_pct.replay")
    invs = [inv(0, 0.1, 1.0, 10, 8), inv(0, 0.1, 11.0, 10, 8)]
    cfg = tiny_config()
    want = 100 * 8 * counters.detector_flops_per_canvas(cfg) / (
        10.0 * counters.BF16_PEAK_FLOPS)
    assert read(run("replay", invs)) == pytest.approx(want)


def test_trace_union_idle_and_readers():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.5, 11.0)]
    assert union_length(iv, 0.0, 10.0) == pytest.approx(3.5)
    assert idle_gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.5)]
    tr = TraceData([("stitch_embed_wgmma_kernel", 0.0, 0.001),
                    ("gemm", 0.5, 2.0), ("stitch_embed_wgmma_kernel",
                                          3.0, 3.002)], 10.0)
    assert tr.busy_s == pytest.approx(1.5 + 0.001 + 0.002)
    idle = harness.load_reader("device_idle_pct.replay")
    assert idle(run("replay", trace=tr)) == pytest.approx(
        100 * (1 - tr.busy_s / 10.0))
    assert idle(run("replay")) is None
    k4 = harness.load_reader("k4_roofline.replay")
    rec = np.zeros((1, 1, 6), np.int32)
    rec[0, 0] = (1, 0, 0, 0, 128, 128)
    invs = [inv(0, 0.1, 1, 1, 1, records=rec),
            inv(2, 2.1, 3, 1, 1, records=rec)]
    bound = counters.k4_bound_s(rec, tiny_config())
    assert k4(run("replay", invs, trace=tr)) == pytest.approx(
        100 * 2 * bound / 0.003)
    # a launch the trace lacks: nothing sound to read
    assert k4(run("replay", invs[:1], trace=tr)) is None


def test_breakdown_names_what_the_host_did():
    tr = TraceData([("k", 0.0, 1.0), ("k", 4.0, 10.0)], 10.0)
    r = run("replay")
    r.spans = [("submit", 1.0, 3.0)]
    out = tr.breakdown(r)
    assert out["device_ops"] == [["k", pytest.approx(7.0)]]
    assert out["idle_gaps"][0][0].startswith("host staging")
    assert out["idle_gaps"][0][1] == pytest.approx(3.0)


def test_spread_is_the_quartile_distance_over_the_median():
    import statistics
    from tangram_bench import spread
    values = [100.0, 101.0, 99.0, 102.0, 98.0, 100.0]
    q1, _, q3 = statistics.quantiles(values, n=4)
    med, sp = spread.spread(values)
    assert med == 100.0
    assert sp == pytest.approx((q3 - q1) / 100.0)
