"""device_idle_pct.replay: share of the window in which no kernel, copy
or memset ran on the card, from the trace, in %."""


def read(run):
    if run.mode != "replay" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
