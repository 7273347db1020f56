"""Patch geometry and packing: the port (``repro_torch.core``) against the
JAX package on the same patch lists.  Both are plain Python/numpy, so
every record, placement and bucket must be identical."""
import dataclasses

import numpy as np
import pytest

from repro.core import partitioning as jpart
from repro.core import stitching as jstitch
from repro_torch.core import partitioning as tpart
from repro_torch.core import stitching as tstitch


def _patch_lists(seed, m, n, count):
    rng = np.random.default_rng(seed)
    def size(lo, hi_w, hi_h):
        return int(rng.integers(lo, hi_w)), int(rng.integers(lo, hi_h))
    # mostly up to half the canvas, a fifth up to the whole canvas
    sizes = [size(1, n + 1, m + 1) if rng.random() < 0.2 else
             size(8, n // 2 + 1, m // 2 + 1) for _ in range(count)]
    jp = [jpart.Patch(0, 0, w, h, frame_id=i % 4, t_gen=0.1 * i)
          for i, (w, h) in enumerate(sizes)]
    tp = [tpart.Patch(**dataclasses.asdict(p)) for p in jp]
    return jp, tp


def _plans(jp, tp, m, n):
    jc, tc = jstitch.stitch(jp, m, n), tstitch.stitch(tp, m, n)
    return (jstitch.build_batch_plan(jp, jc, m, n),
            tstitch.build_batch_plan(tp, tc, m, n), jc, tc)


@pytest.mark.parametrize("seed,m,n,count", [
    (0, 128, 128, 9), (1, 128, 256, 17), (2, 1024, 1024, 40),
    (3, 64, 64, 3), (4, 256, 128, 33)])
def test_batch_plan_matches_reference(seed, m, n, count):
    jp, tp = _patch_lists(seed, m, n, count)
    jplan, tplan, jc, tc = _plans(jp, tp, m, n)
    np.testing.assert_array_equal(tplan.records, jplan.records)
    assert tplan.records.dtype == np.int32
    assert list(tplan.placements()) == list(jplan.placements())
    for field in ("num_canvases", "num_patches", "slots_per_canvas", "hmax",
                  "wmax", "slot_capacity", "canvas_m", "canvas_n"):
        assert getattr(tplan, field) == getattr(jplan, field), field
    assert [dataclasses.astuple(p) for c in tc for p in c.placements] == \
        [dataclasses.astuple(p) for c in jc for p in c.placements]
    tstitch.validate(tc)
    # K is pow2 and padding records are all zero
    k = tplan.slots_per_canvas
    assert k & (k - 1) == 0
    for bi, canvas in enumerate(tc):
        assert not tplan.records[bi, len(canvas.placements):].any()


def test_empty_plan_matches_reference():
    jplan = jstitch.build_batch_plan([], [], 128, 128)
    tplan = tstitch.build_batch_plan([], [], 128, 128)
    assert tplan.records.shape == jplan.records.shape == (0, 1, 6)
    assert (tplan.hmax, tplan.wmax, tplan.slot_capacity) == \
        (jplan.hmax, jplan.wmax, jplan.slot_capacity)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_incremental_pack_equals_from_scratch(seed):
    _, tp = _patch_lists(seed, 128, 128, 25)
    state = tstitch.PackState(128, 128)
    for i, p in enumerate(tp):
        state.append(p)
        scratch = tstitch.stitch(tp[:i + 1], 128, 128)
        assert [c.placements for c in state.canvases] == \
            [c.placements for c in scratch]
        assert [c.free for c in state.canvases] == [c.free for c in scratch]


def test_oversized_patch_raises():
    with pytest.raises(ValueError):
        tstitch.stitch([tpart.Patch(0, 0, 129, 8)], 128, 128)


@pytest.mark.parametrize("seed,zones", [(0, (4, 4)), (1, (2, 3)),
                                        (2, (4, 4)), (3, (1, 1))])
def test_partition_host_matches_reference(seed, zones):
    rng = np.random.default_rng(seed)
    w, h = 512, 256
    x0 = rng.integers(0, w - 8, 20)
    y0 = rng.integers(0, h - 8, 20)
    boxes = np.stack([x0, y0, np.minimum(x0 + rng.integers(4, 90, 20), w),
                      np.minimum(y0 + rng.integers(4, 90, 20), h)],
                     -1).astype(np.int32)
    kw = dict(frame_id=7, camera_id=2, t_gen=1.5, slo=0.5)
    want = jpart.partition_host(boxes, w, h, *zones, **kw)
    got = tpart.partition_host(boxes, w, h, *zones, **kw)
    assert [dataclasses.astuple(p) for p in got] == \
        [dataclasses.astuple(p) for p in want]
    assert tpart.partition_host(boxes[:0], w, h, *zones) == []
