"""pack_ms_per_canvas.replay: host ms in the port's ``stage.plan`` (the
batch plan and its check) and ``stage.pack`` (the crop gather and
``pack_plan_host``) per canvas, over the invocations whose ``stage`` starts
in the window of a replay cell."""
from tangram_bench import program_spans


def read(run):
    if run.mode != "replay":
        return None
    return program_spans.ms_per_canvas(run, ("stage.plan", "stage.pack"))
