"""mfu_pct.replay: the detector's operations (patch embed, trunk, head) on
the canvases routed in the window, over the window's seconds at the card's
bf16 peak, in %."""
from tangram_bench import counters


def read(run):
    if run.mode != "replay":
        return None
    canvases = sum(r.n_canvases for r in run.invs
                   if r.t_routed is not None and r.t_routed <= run.seconds)
    if not canvases:
        return None
    flops = canvases * counters.detector_flops_per_canvas(run.cfg)
    return 100.0 * flops / (run.seconds * counters.BF16_PEAK_FLOPS)
