"""Quickstart on the PyTorch + CUDA port: the Tangram pipeline in ~80 lines.

Synthetic camera -> GMM background subtraction (the hand-written K5
kernel on the card) -> RoIs -> adaptive frame partitioning (Alg. 1) ->
patch stitching + SLO-aware batching (Alg. 2) -> serverless platform
simulation -> cost / SLO report.  The counterpart of
``examples/quickstart.py``, with its sizes and its printed report.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The offline latency profile is the analytical model of the detector on
one H100 (``detector_latency_model``, ``config.HardwareConfig``); the JAX
example's ``chips=4`` names a four-chip TPU slice.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import gmm, partitioning, rois
from repro_torch.core.config import ServeConfig
from repro_torch.core.latency import LatencyTable, detector_latency_model
from repro_torch.core.scheduler import TangramScheduler
from repro_torch.data.synthetic import Scene, preset
from repro_torch.device import resolve_device
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.serverless.platform import Platform, PlatformConfig

WIDTH, HEIGHT, CANVAS, SLO = 480, 272, 128, 1.0
FRAMES = 40


def edge_stream(device=None, gmm_impl=None):
    """The edge side: (patches of 40 frames of scene 0, frames seen).
    ``gmm_impl`` as in ``gmm_ops.gmm_update`` (``None``: K5 on the card,
    the plain version on the CPU)."""
    device = resolve_device(device)
    scene = Scene(preset(0, width=WIDTH, height=HEIGHT))
    state = gmm.init_state(HEIGHT, WIDTH, device=device)
    stream = []
    for t, frame, gt in scene.frames(FRAMES):
        state, fg = gmm_ops.gmm_update(
            state, torch.from_numpy(frame).to(device), impl=gmm_impl)
        if t < 1.0:                       # background model warmup
            continue
        boxes, valid = rois.extract_rois(fg)
        b = boxes[valid].cpu().numpy()
        patches = partitioning.partition_host(
            b, WIDTH, HEIGHT, 4, 4, frame_id=scene.t, t_gen=t, slo=SLO)
        # enclosing rects can exceed zones; clamp to the canvas tile
        stream.extend(partitioning.Patch(
            p.x0, p.y0, min(p.x1, p.x0 + CANVAS), min(p.y1, p.y0 + CANVAS),
            p.frame_id, p.camera_id, p.t_gen, p.slo) for p in patches)
    return stream, scene.t


def cloud_report(stream, table: LatencyTable):
    """The cloud side: the stream through the SLO-aware scheduler on the
    platform model over a 20 Mbps uplink; prints the report and returns
    the run's ``Results``."""
    platform = Platform(table, PlatformConfig())
    scheduler = TangramScheduler(CANVAS, CANVAS, table, platform,
                                 config=ServeConfig(check_invariants=True))
    res = scheduler.run([stream], bandwidth_bps=20e6)

    print("\n--- Tangram report (20 Mbps uplink, SLO 1.0 s) ---")
    for k, v in res.summary().items():
        print(f"  {k:22s} {v}")
    print(f"  canvases/invocation    "
          f"{np.mean(res.batch_sizes):.2f}")
    return res


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    stream, n_frames = edge_stream(args.device)
    print(f"edge produced {len(stream)} patches over "
          f"{n_frames} frames (mean {len(stream)/n_frames:.1f}/frame)")

    # offline latency profile (mu + 3 sigma slack, Section III-C)
    table = detector_latency_model(CANVAS, CANVAS).build_table(16)
    return stream, cloud_report(stream, table)


if __name__ == "__main__":
    main()
