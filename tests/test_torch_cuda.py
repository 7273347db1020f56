"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions.  Every test here needs a CUDA device and skips without one (a
CUDA kernel has no CPU mode); the file imports neither JAX nor the JAX
package, so it runs on a host with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import ServingEngine, make_executor, uniform_pool
from repro_torch.core.latency import LatencyTable
from repro_torch.core.partitioning import Patch
from repro_torch.core.stitching import build_batch_plan, stitch
from repro_torch.kernels.stitch import ops
from repro_torch.kernels.stitch import stitch as kernels
from repro_torch.launch.serve import build_detector
from repro_torch.sources import make_source

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "uint8": torch.uint8}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _plan(kind, m, rng):
    if kind == "random":
        sizes = [(int(rng.integers(8, m // 2 + 1)),
                  int(rng.integers(8, m // 2 + 1))) for _ in range(20)]
    elif kind == "flush":
        sizes = [(m // 2, m // 2)] * 4 + [(m, m), (m - 24, 16), (24, m)]
    else:
        sizes = []
    patches = [Patch(0, 0, w, h) for w, h in sizes]
    return build_batch_plan(patches, stitch(patches, m, m), m, m), patches


@pytest.mark.parametrize("kind", ["random", "flush", "empty"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernels_bit_exact_against_plain(cuda, dtype, kind):
    m = 1024
    rng = np.random.default_rng(11)
    plan, patches = _plan(kind, m, rng)
    crops = [rng.integers(0, 120, size=(p.h, p.w, 3)).astype(np.float32)
             for p in patches]
    slots = torch.from_numpy(ops.pack_plan_host(crops, plan)).to(
        cuda, DTYPES[dtype])
    rec = torch.from_numpy(plan.records).to(cuda)
    before = dict(kernels.LAUNCHES)
    got = ops.stitch_canvases(slots, rec, m, m, impl="cuda")
    assert torch.equal(got, ops.stitch_canvases(slots, rec, m, m,
                                                impl="torch"))
    args = (plan.slot_capacity, plan.hmax, plan.wmax)
    back = ops.unstitch_patches(got, rec, *args, impl="cuda")
    assert torch.equal(back, ops.unstitch_patches(got, rec, *args,
                                                  impl="torch"))
    launched = 0 if kind == "empty" else 1
    assert kernels.LAUNCHES["stitch"] == before["stitch"] + launched
    assert kernels.LAUNCHES["unstitch"] == before["unstitch"] + launched


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    slots = torch.zeros((2, 8, 8, 3), device=cuda)
    rec = torch.zeros((1, 2, 6), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="records"):
        ops.stitch_canvases(slots, rec.long(), 64, 64)
    with pytest.raises(ValueError, match="dtype"):
        ops.stitch_canvases(slots.double(), rec, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        ops.stitch_canvases(slots.transpose(1, 2), rec, 64, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.stitch_canvases(slots, rec.cpu(), 64, 64)


@pytest.mark.parametrize("executor", ["device", "async_device"])
def test_executor_on_card_matches_plain_run(cuda, executor):
    """The small driver detector served on the card: kernels and plain
    versions route the same detections and evidence.  The executors' clock
    is pinned so completions deliver in submit order in both runs (with
    measured wall times, two invocations may finish in either order)."""
    frames = {}
    src = make_source("synthetic", n_frames=16, canvas=128, slo=0.3,
                      device=cuda, frame_sink=lambda f, px, n:
                      frames.__setitem__(f, (px, n)))
    arrivals = list(src.events(None))
    _, params, serve_fn = build_detector(128, cuda)
    table = LatencyTable({1: (0.02, 0.002), 4: (0.05, 0.004)})
    outs = []
    for impl in (None, "torch"):
        ex = make_executor(executor, serve_fn=serve_fn, params=params,
                           canvas_m=128, canvas_n=128, device=cuda,
                           impl=impl, clock=lambda: 0.0)
        routed = []
        release = ex.on_complete

        def on_complete(comp, routed=routed, release=release):
            routed.append(comp.outputs)
            release(comp)

        ex.on_complete = on_complete
        for fid, (px, n) in frames.items():
            ex.add_frame(fid, px, n)
        ServingEngine(uniform_pool(128, 128, table, max_canvases=4),
                      ex).run(arrivals)
        assert len(ex.frames) == 0
        outs.append(routed)
    assert len(outs[0]) == len(outs[1]) > 0
    for (dets_k, px_k), (dets_p, px_p) in zip(*outs):
        assert dets_k == dets_p
        for fid in px_p:
            for a, b in zip(px_k[fid], px_p[fid]):
                np.testing.assert_array_equal(a, b)
