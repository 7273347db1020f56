"""slo_miss_pct.live: share of the window's patches routed later than
capture + SLO (``PatchOutcome.violated``), misses included, in %."""
from tangram_bench import stats


def read(run):
    if run.mode != "live":
        return None
    lat = stats.latencies(run)
    if not lat:
        return None
    return 100.0 * sum(1 for x in lat if x > run.slo) / len(lat)
