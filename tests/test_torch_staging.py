"""The executor's staging: crops packed back to back with no padding
(``pack_plan_compact``), laid out into the plan's slots on the device
(``lay_out_slots``), from reused host buffers (``HostStaging``).  Held
against the padded host packing (``pack_plan_host``) and against a copy of
the executor that stages with it: the same slots, padding included, and
the same completions, bit for bit.  The fused path's evidence is a
read-only view of the frame where that equals the padded slot, else a
private copy (``crop_evidence``)."""
import collections

import numpy as np
import pytest
import torch

from repro_torch.config import DetectorConfig
from repro_torch.core.engine import (AsyncDeviceExecutor, DeviceExecutor,
                                     HostStaging, make_executor)
from repro_torch.core.invoker import Invocation
from repro_torch.core.partitioning import Patch
from repro_torch.core.stitching import build_batch_plan, stitch
from repro_torch.core.workers import WorkerPoolExecutor
from repro_torch.kernels.stitch import ops
from repro_torch.launch.serve import fused_kwargs
from repro_torch.models import detector as tdet

M = 128
MAX_INFLIGHT = 2


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _plan_and_crops(kind, c, seed=3):
    """A packed plan over views of larger frames, as the executor crops
    them: mixed sizes (9 patches: 16 slots), one missing frame (a zero
    crop), one patch alone, or four that fill their power-of-two slots
    exactly (no padding)."""
    rng = np.random.default_rng(seed)
    if kind == "mixed" or kind == "missing":
        sizes = [(int(rng.integers(8, M // 2 + 1)),
                  int(rng.integers(8, M // 2 + 1))) for _ in range(9)]
    elif kind == "single":
        sizes = [(37, 21)]
    else:
        sizes = [(32, 32)] * 4
    frame = rng.normal(size=(2 * M, 2 * M, c)).astype(np.float32)
    patches, crops = [], []
    for i, (w, h) in enumerate(sizes):
        x, y = int(rng.integers(0, M)), int(rng.integers(0, M))
        patches.append(Patch(x, y, x + w, y + h, frame_id=i))
        crops.append(frame[y:y + h, x:x + w])
    if kind == "missing":
        crops[4] = np.zeros_like(crops[4])
    plan = build_batch_plan(patches, stitch(patches, M, M), M, M)
    return plan, crops


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("kind", ["mixed", "missing", "single", "exact"])
def test_compact_layout_equals_padded_host_slots(kind, c):
    """``lay_out_slots`` of ``pack_plan_compact`` equals ``pack_plan_host``
    everywhere, padding and the slots past the patches included; the
    offsets and extents cover each crop once, back to back."""
    plan, crops = _plan_and_crops(kind, c)
    assert plan.slot_capacity >= len(crops)
    if kind == "mixed":
        assert plan.slot_capacity > len(crops)
    packed = ops.pack_plan_compact(crops, plan)
    host = ops.pack_plan_host(crops, plan)
    slots = ops.lay_out_slots(torch.from_numpy(packed.flat), packed, plan)
    assert slots.dtype == torch.float32 and slots.shape == host.shape
    np.testing.assert_array_equal(_bits(slots.numpy()), _bits(host))

    sizes = [px.shape[0] * px.shape[1] * c for px in crops]
    assert packed.offsets.tolist() == np.cumsum([0] + sizes[:-1]).tolist()
    assert packed.hw.tolist() == [list(px.shape[:2]) for px in crops]
    assert packed.flat.size == sum(sizes) <= host.size
    if kind == "exact":
        assert packed.flat.size == host.size
    for i, px in enumerate(crops):
        np.testing.assert_array_equal(_bits(packed.crop(i)), _bits(px))


def test_compact_pack_writes_into_a_given_buffer():
    plan, crops = _plan_and_crops("mixed", 3)
    fresh = ops.pack_plan_compact(crops, plan)
    buf = np.full(fresh.flat.size + 50, np.nan, np.float32)
    packed = ops.pack_plan_compact(crops, plan, out=buf)
    assert np.shares_memory(packed.flat, buf)
    np.testing.assert_array_equal(_bits(packed.flat), _bits(fresh.flat))
    assert np.isnan(buf[fresh.flat.size:]).all()
    with pytest.raises(ValueError, match="at least"):
        ops.pack_plan_compact(crops, plan, out=buf[:fresh.flat.size - 1])


@pytest.mark.parametrize("pack", [ops.pack_plan_host, ops.pack_plan_compact])
def test_crop_larger_than_its_slot_raises(pack):
    plan, crops = _plan_and_crops("mixed", 3)
    crops[2] = np.zeros((plan.hmax + 1, 4, 3), np.float32)
    with pytest.raises(ValueError, match="exceeds the plan's slot"):
        pack(crops, plan)


# ------------------------------------------------------------ executor ----

class _PaddedCrops:
    """What the padded staging leaves for routing: the host slots, each
    cut to its patch (the evidence routing copied out of them)."""

    def __init__(self, slots, patches):
        self.crops = [slots[i, :p.h, :p.w] for i, p in enumerate(patches)]

    def release(self):
        pass


class _PaddedStaging:
    """The executor staging as before the compact path: every crop into a
    padded host slot array, shipped whole with the records."""

    def _stage(self, inv, plan, rt):
        host = ops.pack_plan_host(self._crops(inv), plan)
        return (torch.from_numpy(host).to(self.device),
                torch.from_numpy(plan.records).to(self.device),
                _PaddedCrops(host, inv.patches))


class _PaddedDevice(_PaddedStaging, DeviceExecutor):
    pass


class _PaddedAsync(_PaddedStaging, AsyncDeviceExecutor):
    pass


def _detector():
    cfg = DetectorConfig(name="tiny", canvas=M, patch=32, n_layers=2,
                         d_model=64, n_heads=4, d_ff=128)
    return cfg, tdet.init_params(cfg, torch.Generator().manual_seed(0),
                                 torch.device("cpu"))


def _executor(cls, fuse):
    cfg, params = _detector()
    kw = fused_kwargs(cfg, params) if fuse else {}
    extra = {"max_inflight": MAX_INFLIGHT} if issubclass(
        cls, AsyncDeviceExecutor) else {}
    return cls(tdet.serve_fn(cfg), params, M, M, device="cpu", impl="torch",
               clock=lambda: 0.0, **extra, **kw)


def _invocations(n, seed=11):
    """``n`` invocations over three frames: one never stored (its patches
    stage zeros), one smaller than the patches' range (crops cut short at
    its edge, their slots padded past it); each with ``slot_capacity``
    above its patch count; the most canvases first."""
    rng = np.random.default_rng(seed)
    frames = {0: rng.random((160, 224, 3), dtype=np.float32),
              1: rng.random((90, 130, 3), dtype=np.float32)}
    invs = []
    for _ in range(n):
        k = int(rng.integers(5, 8))
        patches = []
        for i in range(k):
            w, h = int(rng.integers(12, 72)), int(rng.integers(12, 72))
            x = int(rng.integers(0, 224 - w))
            y = int(rng.integers(0, 160 - h))
            patches.append(Patch(x, y, x + w, y + h, frame_id=i % 3))
        invs.append(Invocation(0.0, stitch(patches, M, M), patches, 0.0,
                               "timer"))
    invs.sort(key=lambda inv: -len(inv.canvases))
    return frames, invs


def _by_patch(comp):
    """A completion's evidence arrays in its invocation's patch order."""
    left = {fid: iter(px) for fid, px in comp.outputs[1].items()}
    return [next(left[p.frame_id]) for p in comp.invocation.patches]


def _is_view(frames, patch):
    """Whether the fused path hands out a view of the patch's frame: the
    frame is stored, float32, and holds the whole patch."""
    frame = frames.get(patch.frame_id)
    return (frame is not None and frame.dtype == np.float32
            and frame[patch.y0:patch.y1, patch.x0:patch.x1].shape[:2]
            == (patch.h, patch.w))


def _serve(ex, frames, invs):
    """Submit in order, holding at most ``max_inflight`` unresolved (as the
    engine does); the completions in submit order, and the executor's
    counters after the first ``max_inflight + 2``."""
    for fid, px in frames.items():
        ex.add_frame(fid, px, 10 ** 6)
    bound = getattr(ex, "max_inflight", 1)
    held, comps, counters = collections.deque(), [], None
    for k, inv in enumerate(invs):
        while len(held) >= bound:
            comps.append(ex.resolve(held.popleft()))
        held.append(ex.submit(inv))
        if k + 1 == MAX_INFLIGHT + 2:
            counters = (ex.pinned_allocs, ex.staging.n_buffers)
    comps.extend(ex.resolve(h) for h in held)
    return comps, counters


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("kind", ["device", "async_device"])
def test_executor_completions_equal_padded_staging(kind, fuse):
    """Detections and evidence equal, bit for bit, those of the executor
    staging padded slots; the fused path's evidence is a read-only view
    of its frame wherever the frame is stored and holds the whole patch,
    the frame stays writeable, and every other patch's (and the unfused
    path's) is a private copy, each counted; ``h2d_bytes`` is the crops'
    and the records' bytes; the pool stops allocating once
    ``max_inflight`` invocations have been held, and never holds more
    buffers than that plus one."""
    cls, ref_cls = ((DeviceExecutor, _PaddedDevice) if kind == "device"
                    else (AsyncDeviceExecutor, _PaddedAsync))
    frames, invs = _invocations(2 * (MAX_INFLIGHT + 2))
    ex = _executor(cls, fuse)
    comps, (allocs, n_buffers) = _serve(ex, frames, invs)
    ref_ex = _executor(ref_cls, fuse)
    ref, _ = _serve(ref_ex, frames, invs)

    assert len(comps) == len(ref) == len(invs)
    for got, want in zip(comps, ref):
        assert got.invocation is want.invocation
        dets, pixels = got.outputs
        want_dets, want_pixels = want.outputs
        assert dets == want_dets
        assert pixels.keys() == want_pixels.keys()
        for fid in want_pixels:
            assert len(pixels[fid]) == len(want_pixels[fid])
            for a, b in zip(pixels[fid], want_pixels[fid]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(_bits(a), _bits(b))
        for p, a in zip(got.invocation.patches, _by_patch(got)):
            if fuse and _is_view(frames, p):
                assert np.shares_memory(a, frames[p.frame_id])
                assert not a.flags.writeable
            else:
                assert a.flags.owndata and a.flags.writeable
    assert all(px.flags.writeable for px in frames.values())
    patches = [p for inv in invs for p in inv.patches]
    views = sum(fuse and _is_view(frames, p) for p in patches)
    assert 0 < views < len(patches) or not fuse
    assert (ex.evidence_views, ex.evidence_copies) == (
        views, len(patches) - views)
    assert ex.evidence_bytes == ref_ex.evidence_bytes > 0

    crops = [frames[p.frame_id][p.y0:p.y1, p.x0:p.x1] if p.frame_id in frames
             else np.zeros((p.h, p.w, 3)) for p in patches]
    assert any(px.shape[:2] != (p.h, p.w) for px, p in zip(crops, patches))
    shipped = (4 * sum(px.size for px in crops)
               + sum(inv.batch_plan().records.nbytes for inv in invs))
    assert ex.h2d_bytes == shipped
    bound = getattr(ex, "max_inflight", 1)
    assert n_buffers <= bound + 1
    assert ex.staging.n_buffers == n_buffers
    assert ex.pinned_allocs == allocs
    assert len(ex.staging.free) == ex.staging.n_buffers


@pytest.mark.parametrize("case", ["inside", "missing", "edge", "uint8"])
def test_fused_evidence_is_a_view_only_where_it_equals_the_slot(case):
    """Patches inside a stored float32 frame: read-only views of it.  A
    frame the store never held, a patch cut short at the frame's edge and
    a uint8 frame: private float32 arrays.  Each equals, bit for bit, the
    padded slot's evidence, and is counted as a view or a copy."""
    rng = np.random.default_rng(5)
    shape = (40, 60, 3) if case == "edge" else (96, 128, 3)
    frame = (rng.integers(0, 256, shape).astype(np.uint8) if case == "uint8"
             else rng.random(shape, dtype=np.float32))
    frames = {} if case == "missing" else {0: frame}
    patches = [Patch(4, 8, 36, 40, frame_id=0),
               Patch(40, 20, 72, 52, frame_id=0),
               Patch(16, 4, 40, 20, frame_id=0)]
    inv = Invocation(0.0, stitch(patches, M, M), patches, 0.0, "timer")
    ex = _executor(DeviceExecutor, True)
    (got,), _ = _serve(ex, frames, [inv])
    (want,), _ = _serve(_executor(_PaddedDevice, True), frames, [inv])

    views = [_is_view(frames, p) for p in patches]
    assert views == ([True] * 3 if case == "inside" else
                     [True, False, True] if case == "edge" else [False] * 3)
    for p, view, a, b in zip(patches, views, _by_patch(got),
                             _by_patch(want)):
        assert a.dtype == np.float32 and a.shape == b.shape == (p.h, p.w, 3)
        np.testing.assert_array_equal(_bits(a), _bits(b))
        if view:
            assert np.shares_memory(a, frame) and not a.flags.writeable
        else:
            assert a.flags.owndata and a.flags.writeable
            assert not np.shares_memory(a, frame)
    assert frame.flags.writeable
    assert (ex.evidence_views, ex.evidence_copies) == (sum(views),
                                                       3 - sum(views))


def test_staging_pool_reuses_and_grows_only_when_short():
    pool = HostStaging(pin=False)
    a = pool.take(100, reserve=400)
    assert (a.array.size, pool.allocs, pool.n_buffers) == (400, 1, 1)
    assert a.event is None and a.host.dtype == torch.float32
    pool.give(a)
    assert pool.take(300) is a and pool.allocs == 1
    b = pool.take(50)                 # a is lent: a second buffer
    assert b is not a and b.array.size == 400
    pool.give(a)
    pool.give(b)
    c = pool.take(500)                # none holds 500: the largest grows
    assert c.array.size == 500 and (pool.allocs, pool.n_buffers) == (3, 2)
    pool.give(c)
    assert pool.take(450) is c and pool.allocs == 3


def test_worker_pool_sums_staging_counters():
    frames, invs = _invocations(2)
    workers = [_executor(DeviceExecutor, True) for _ in range(2)]
    for w, inv in zip(workers, invs):
        _serve(w, frames, [inv])
    pool = WorkerPoolExecutor(workers)
    assert pool.h2d_bytes == sum(w.h2d_bytes for w in workers) > 0
    assert pool.pinned_allocs == 2
    for name in ("evidence_views", "evidence_copies"):
        assert getattr(pool, name) == sum(getattr(w, name) for w in workers)
        assert all(getattr(w, name) > 0 for w in workers)
    assert pool.evidence_views + pool.evidence_copies == sum(
        len(inv.patches) for inv in invs)


def test_make_executor_stages_through_its_pool():
    cfg, params = _detector()
    ex = make_executor("async_device", serve_fn=tdet.serve_fn(cfg),
                       params=params, canvas_m=M, canvas_n=M, device="cpu",
                       impl="torch", max_inflight=3,
                       **fused_kwargs(cfg, params))
    frames, invs = _invocations(1)
    for fid, px in frames.items():
        ex.add_frame(fid, px, 10 ** 6)
    handle = ex.submit(invs[0])
    staged = handle.payload["staged"]
    assert not staged.buf.host.is_pinned()    # off a card: host memory
    assert ex.staging.free == []
    ex.resolve(handle)
    assert ex.staging.free == [staged.buf]
