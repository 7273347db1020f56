"""event_lag_ms_p95.live: the 95th percentile, by nearest rank, of how late
the port's engine took its events (``engine.late``: arrivals, timers,
completions; 0 when on time), over the events due in the window of a live
cell, in ms."""
from tangram_bench import program_spans, stats


def read(run):
    if run.mode != "live":
        return None
    recs = program_spans.records(run)
    if not recs:
        return None
    lags = [r[2] - r[1] for r in
            program_spans.in_window(recs, "engine.late", run.seconds)]
    if not lags:
        return None
    return stats.nearest_rank(lags, 0.95) * 1e3
