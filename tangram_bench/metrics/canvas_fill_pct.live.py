"""canvas_fill_pct.live: mean share of a canvas that placed patches cover,
over the canvases of invocations submitted in the window, in %."""
from tangram_bench import stats


def read(run):
    if run.mode != "live":
        return None
    areas = [a for r in stats.window_invs(run) for a in r.used_area]
    if not areas:
        return None
    return 100.0 * sum(areas) / (len(areas) * run.cfg["canvas"] ** 2)
