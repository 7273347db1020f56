"""timer_fire_pct.live: share of the invocations fired in the window of a
live cell that the invoker's timer fired (the port's ``fire`` events whose
reason is ``timer``: a part-filled batch, the dearest kind per patch), in
%."""
from tangram_bench import program_spans


def read(run):
    if run.mode != "live":
        return None
    recs = program_spans.records(run)
    if not recs:
        return None
    fired = program_spans.in_window(recs, "fire", run.seconds)
    if not fired:
        return None
    return 100.0 * sum(1 for r in fired if r[5] == "timer") / len(fired)
