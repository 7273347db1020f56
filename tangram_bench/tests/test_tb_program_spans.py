"""The readers of the port's own spans: the window is the invocations whose
``stage`` starts inside it, joined on ``inv``; ``route`` is read less its
``route.wait``; lateness is a nearest-rank p95; the spans' host stamps
are put in engine seconds by the window's ``submit`` spans."""
import pytest
from tb_fixtures import tiny_config, tiny_traffic

from tangram_bench import harness, program_spans
from tangram_bench.trace import TraceData

NEW_METRICS = ("pack_ms_per_canvas.replay", "h2d_ms_per_canvas.replay",
               "route_ms_per_canvas.replay", "event_lag_ms_p95.live",
               "timer_fire_pct.live")


def run(mode, recs=None, seconds=10.0, spans=(), trace=None):
    r = harness.RunData(seconds, 0.5, mode, tiny_config(), tiny_traffic(mode),
                        [], [], list(spans), trace)
    if recs is not None:
        r.program_spans = recs
    return r


def invocation(inv, t0, canvases, plan=0.001, pack=0.002, h2d=0.010,
               wait=0.050, route=0.080):
    """One invocation's ``stage`` and ``route`` trees from ``t0``, its
    records' parents counted from index 0 (shift them with :func:`at`)."""
    t = t0
    stage = ("stage", t, t + plan + pack + h2d + 0.001, None, inv, canvases)
    kids = [("stage.plan", t, t + plan, 0, inv, None),
            ("stage.pack", t + plan, t + plan + pack, 0, inv, None),
            ("stage.h2d", t + plan + pack, t + plan + pack + h2d, 0, inv,
             None)]
    r0 = t + 1.0
    return [stage, *kids,
            ("route", r0, r0 + route, None, inv, canvases),
            ("route.wait", r0, r0 + wait, 4, inv, None),
            ("route.fused", r0 + wait, r0 + wait + 0.01, 4, inv, None)]


def at(recs, offset):
    return [(n, a, b, None if p is None else p + offset, i, v)
            for n, a, b, p, i, v in recs]


def replay_records():
    recs = []
    # warm-up (before engine second 0), in the window, at its edge, after
    for inv, t0, canvases in ((0, -5.0, 8), (1, 0.0, 8), (2, 9.5, 2),
                              (3, 10.0, 8), (4, 12.0, 8)):
        recs += at(invocation(inv, t0, canvases), len(recs))
    return recs


def test_staging_readers_count_the_window_by_stage_start():
    recs = replay_records()
    pack = harness.load_reader("pack_ms_per_canvas.replay")
    h2d = harness.load_reader("h2d_ms_per_canvas.replay")
    # invocations 1 and 2: 10 canvases
    assert pack(run("replay", recs)) == pytest.approx(2 * 3.0 / 10)
    assert h2d(run("replay", recs)) == pytest.approx(2 * 10.0 / 10)
    assert pack(run("live", recs)) is None
    # a window that holds only the warm-up's negative stamps: nothing
    assert pack(run("replay", recs[:7])) is None


def test_route_reads_without_the_wait():
    read = harness.load_reader("route_ms_per_canvas.replay")
    recs = replay_records()
    # (80 - 50) ms an invocation, two in the window, 10 canvases
    assert read(run("replay", recs)) == pytest.approx(2 * 30.0 / 10)
    # a wait that is not route's child is not taken off
    orphan = [(n, a, b, None if n == "route.wait" else p, i, v)
              for n, a, b, p, i, v in recs]
    assert read(run("replay", orphan)) == pytest.approx(2 * 80.0 / 10)


def test_event_lag_p95_by_nearest_rank_over_events_due_in_the_window():
    read = harness.load_reader("event_lag_ms_p95.live")
    # 100 events due in the window: lags 1..100 ms; one due before it and
    # one after it, both later than any
    recs = [("engine.late", 0.05 * k, 0.05 * k + 1e-3 * (k + 1), None, None,
             "arrival") for k in range(100)]
    recs += [("engine.late", -1.0, 0.0, None, None, "timer"),
             ("engine.late", 10.0, 11.0, None, None, "timer")]
    assert read(run("live", recs)) == pytest.approx(95.0)
    assert read(run("replay", recs)) is None
    assert read(run("live", recs[:1])) == pytest.approx(1.0)


def test_timer_fire_share_of_the_window():
    read = harness.load_reader("timer_fire_pct.live")
    reasons = ["timer", "timer", "slo_pressure", "memory", "timer"]
    recs = [("fire", 1.0 + k, 1.0 + k, None, None, why)
            for k, why in enumerate(reasons)]
    recs += [("fire", 10.0, 10.0, None, None, "flush"),
             ("fire", -0.5, -0.5, None, None, "memory")]
    assert read(run("live", recs)) == pytest.approx(60.0)
    assert read(run("live", [r for r in recs if r[1] >= 10.0])) is None


def test_a_program_without_spans_gives_nothing_to_read():
    for name in NEW_METRICS:
        read = harness.load_reader(name)
        assert read(run("replay")) is None
        assert read(run("live")) is None


def test_host_stamps_go_to_engine_seconds_by_the_submit_spans():
    epoch = 1000.0
    host = [("stage", epoch - 3.0, epoch - 2.9, None, 0, 8),      # warm-up
            ("stage", epoch + 0.5001, epoch + 0.6, None, 1, 8),
            ("stage.h2d", epoch + 0.55, epoch + 0.59, 1, 1, None),
            ("stage", epoch + 2.00002, epoch + 2.1, None, 2, 4)]
    submits = [("submit", 0.5, 0.6001), ("resolve", 1.0, 1.2),
               ("submit", 2.0, 2.10001)]
    got = program_spans.epoch_of(host, submits)
    assert got == pytest.approx(epoch + 2e-5, abs=1e-9)
    # a stage that ends after its submit did: no epoch
    late = host[:3] + [("stage", epoch + 2.00002, epoch + 2.2, None, 2, 4)]
    assert program_spans.epoch_of(late, submits) is None
    assert program_spans.epoch_of(host, []) is None


def test_idle_gaps_named_by_the_innermost_span():
    recs = [("engine.sleep", 0.0, 2.0, None, None, None),
            ("stage", 2.0, 3.0, None, 0, 1),
            ("stage.h2d", 2.2, 2.9, 1, 0, None),
            ("engine.late", 0.0, 5.0, None, None, "arrival"),
            ("route", 6.0, 8.0, None, 0, 1),
            ("route.evidence", 6.5, 7.5, 4, 0, None)]
    tr = TraceData([("k", 2.9, 6.0), ("k", 8.5, 10.0)], 10.0)
    r = run("live", recs, trace=tr, spans=[("resolve", 6.0, 8.0)])
    by = program_spans.idle_by_span(r)
    assert by == pytest.approx({"engine.sleep": 2.0, "stage": 0.2,
                                "stage.h2d": 0.7, "route": 1.0,
                                "route.evidence": 1.0, None: 0.5})
    labels = program_spans.gap_labels(r)
    assert labels[0][0] == "host engine/engine.sleep at 0.000 s"
    assert labels[0][1] == pytest.approx(2.9)
    assert labels[1][0] == "host routing/route.evidence at 6.000 s"
    assert len(labels) == 2
