"""patches_per_s (replay cells): patches routed inside the window over
the window's seconds."""


def read(run):
    if run.mode != "replay":
        return None
    routed = sum(r.n_patches for r in run.invs
                 if r.t_routed is not None and r.t_routed <= run.seconds)
    return routed / run.seconds
