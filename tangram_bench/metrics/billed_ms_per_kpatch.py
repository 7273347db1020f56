"""billed_ms_per_kpatch (live cells): the serverless bill, Eqn. (1)'s
function time: over the invocations submitted in the window, the sum of
(outputs routed - submit) in ms, per thousand patches they carried."""
from tangram_bench import stats


def read(run):
    if run.mode != "live":
        return None
    invs = [r for r in stats.window_invs(run) if r.t_routed is not None]
    patches = sum(r.n_patches for r in invs)
    if not patches:
        return None
    billed_ms = sum(r.t_routed - r.t_submit0 for r in invs) * 1e3
    return billed_ms * 1e3 / patches
