"""staging_ms_per_canvas.replay: host ms inside the worker's submit per
canvas, over the window of a replay cell."""
from tangram_bench import stats


def read(run):
    return stats.staging_ms_per_canvas(run) if run.mode == "replay" else None
