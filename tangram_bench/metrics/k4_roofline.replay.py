"""k4_roofline.replay: K4's least time (``counters.k4_bound_s`` of each
launch's records) over its device time by kernel name in the trace, in %.
Every invocation of the traced stretch launches K4 once; when the counts
disagree there is nothing sound to read."""
from tangram_bench import counters

KERNEL = "stitch_embed"


def read(run):
    if run.mode != "replay" or run.trace is None:
        return None
    events = run.trace.kernels(KERNEL)
    launched = [r for r in run.invs if r.n_canvases]
    if not events or len(events) != len(launched):
        return None
    device_s = sum(b - a for _, a, b in events)
    bound_s = sum(counters.k4_bound_s(r.records, run.cfg) for r in launched)
    return 100.0 * bound_s / device_s
