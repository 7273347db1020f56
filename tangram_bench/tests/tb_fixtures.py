"""The tiny configuration and traffic the benchmark's tests run: a
module of its own name, apart from ``conftest``, so that these tests and
the repository's ``tests/`` can be collected in one session."""


def tiny_config(**over) -> dict:
    """A CPU-sized detector through the same harness: 128^2 canvases,
    patch 16, two layers of width 64, bf16."""
    cfg = dict(name="tiny", canvas=128, patch=16, n_layers=2, d_model=64,
               n_heads=4, d_ff=128, param_dtype="bfloat16",
               compute_dtype="bfloat16", norm_eps=1e-6, obj_share=0.15,
               fuse=True, max_canvases=8, max_inflight=4,
               online_latency=True,
               limits={"k4_token_err": 0.05, "head_err": 8.0,
                       "k3_grid_err": 1e-3})
    cfg.update(over)
    return cfg


def tiny_traffic(mode: str = "replay", **over) -> dict:
    """Three scenes at 512x288, two-frame clips."""
    traffic = dict(name=f"tiny-{mode}", mode=mode, width=512, height=288,
                   scenes=[0, 1, 2], clip_frames=2, warm_steps=5,
                   zones=[4, 4], align=16,
                   slo_s=1e6 if mode == "replay" else 0.5,
                   backlog_frames_per_camera=400, check_invocations=4,
                   fps=2.0, bandwidth_mbps=40.0)
    traffic.update(over)
    return traffic
