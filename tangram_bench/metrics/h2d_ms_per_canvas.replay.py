"""h2d_ms_per_canvas.replay: host ms in the port's ``stage.h2d`` (the
slots' and records' copy to the card) per canvas, over the invocations
whose ``stage`` starts in the window of a replay cell."""
from tangram_bench import program_spans


def read(run):
    if run.mode != "replay":
        return None
    return program_spans.ms_per_canvas(run, ("stage.h2d",))
