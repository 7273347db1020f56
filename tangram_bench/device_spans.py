"""The port's device-timed records in a ``--trace 1`` run: ``trunk`` (K4's
tokens to the head), ``trunk.attn.window`` and ``trunk.attn.global`` (the
window and the global blocks' attention), each one zero-length record an
invocation, written when the invocation is routed, valued in device ms
(``repro_torch.core.spans.device_span``).  A program without them gives
the readers nothing to read."""
from __future__ import annotations

from typing import Optional, Tuple

from tangram_bench import program_spans


def device_ms(run, name: str) -> Optional[Tuple[float, int]]:
    """(device ms summed over the records named ``name``, canvases) of the
    invocations whose ``stage`` starts in the window and that carry such a
    record; None when none does."""
    recs = program_spans.records(run)
    if not recs:
        return None
    invs = program_spans.window_canvases(recs, run.seconds)
    ms, carried = 0.0, set()
    for r in recs:
        if r is not None and r[0] == name and r[4] in invs:
            ms += r[5]
            carried.add(r[4])
    canvases = sum(invs[i] for i in carried)
    if not canvases:
        return None
    return ms, canvases


def ms_per_canvas(run, name: str) -> Optional[float]:
    got = device_ms(run, name)
    return None if got is None else got[0] / got[1]
