"""patch_latency_p95_ms (live cells): the 95th percentile, by nearest
rank, of routed minus capture time over every patch captured in the
window.  A miss (not routed by the window's end plus one SLO) ranks above
every routed patch; where the percentile falls on a miss, the value is
the longest latency measured in the run, which the miss exceeds."""
import math

from tangram_bench import stats


def read(run):
    if run.mode != "live":
        return None
    lat = stats.latencies(run)
    if not lat:
        return None
    p95 = stats.nearest_rank(lat, 0.95)
    if math.isinf(p95):
        p95 = max(tr - tg for tg, tr in run.patches if tr is not None)
    return p95 * 1e3
