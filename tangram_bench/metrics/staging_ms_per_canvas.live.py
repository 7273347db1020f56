"""staging_ms_per_canvas.live: host ms inside the worker's submit per
canvas, over the window of a live cell."""
from tangram_bench import stats


def read(run):
    return stats.staging_ms_per_canvas(run) if run.mode == "live" else None
