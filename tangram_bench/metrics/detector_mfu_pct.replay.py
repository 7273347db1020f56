"""detector_mfu_pct.replay: the trunk's operations (the family's count less
the patch embed, which K4 computes before the trunk starts) on the
canvases of the invocations whose ``stage`` starts in the window, over the
device ms of their ``trunk`` records at the card's bf16 peak, in %: how
well the trunk uses the card while it runs (``mfu_pct.replay`` divides by
the window's seconds instead)."""
from tangram_bench import counters, device_spans


def read(run):
    if run.mode != "replay":
        return None
    got = device_spans.device_ms(run, "trunk")
    if got is None or got[0] <= 0:
        return None
    ms, canvases = got
    cfg = run.cfg
    p = cfg["patch"]
    embed = 2.0 * (cfg["canvas"] // p) ** 2 * (p * p * 3) * cfg["d_model"]
    flops = canvases * (counters.detector_flops_per_canvas(cfg) - embed)
    return 100.0 * flops / (ms * 1e-3 * counters.BF16_PEAK_FLOPS)
