"""route_ms_per_canvas.replay: host ms in the port's ``route`` less its
``route.wait`` child (the host blocked on the card, and the copy of K3's
grids) per canvas, over the invocations whose ``stage`` starts in the
window of a replay cell: ``route_fused``, the evidence copies and the
release of the host slots."""
from tangram_bench import program_spans


def read(run):
    if run.mode != "replay":
        return None
    recs = program_spans.records(run)
    if not recs:
        return None
    invs = program_spans.window_canvases(recs, run.seconds)
    canvases = sum(invs.values())
    if not canvases:
        return None
    busy = 0.0
    for r in recs:
        if r is None:
            continue
        if r[0] == "route" and r[4] in invs:
            busy += r[2] - r[1]
        elif r[0] == "route.wait" and r[3] is not None \
                and recs[r[3]] is not None and recs[r[3]][0] == "route" \
                and recs[r[3]][4] in invs:
            busy -= r[2] - r[1]
    return busy * 1e3 / canvases
