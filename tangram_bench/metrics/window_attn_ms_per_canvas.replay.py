"""window_attn_ms_per_canvas.replay: device ms in the port's
``trunk.attn.window`` records (the window blocks' attention with its
partition, padding, unpartition and crop) per canvas, over the
invocations whose ``stage`` starts in the window of a replay cell."""
from tangram_bench import device_spans


def read(run):
    if run.mode != "replay":
        return None
    return device_spans.ms_per_canvas(run, "trunk.attn.window")
