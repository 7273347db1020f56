"""K1 stitch / K2 unstitch: the port's plain PyTorch versions against the
JAX package's oracles and its Pallas kernels in interpret mode, bit for
bit, in every payload dtype the kernels take.  The hand-written CUDA
kernels are held against the same plain versions on the card
(``chip_smoke.py`` and ``tests/test_torch_cuda.py``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partitioning import Patch as JPatch
from repro.core.stitching import build_batch_plan as jbuild
from repro.core.stitching import stitch as jstitch
from repro.kernels.stitch import ops as jops
from repro.kernels.stitch.ref import stitch_reference, unstitch_reference
from repro.kernels.stitch.stitch import stitch_pallas, unstitch_pallas
from repro_torch.core.partitioning import Patch
from repro_torch.core.stitching import build_batch_plan, stitch
from repro_torch.kernels.stitch import ops

DTYPES = {  # name -> (jax dtype, torch dtype, integer payload range)
    "float32": (jnp.float32, torch.float32, None),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, None),
    "int8": (jnp.int8, torch.int8, (-128, 128)),
    "uint8": (jnp.uint8, torch.uint8, (0, 256)),
}


def _plan(kind, m, seed):
    """Packer-built plan (as in tests/test_fused_kernels.py::_packed_plan),
    one whose placements sit flush with the right/bottom edges, or an
    empty one."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        sizes = [(int(rng.integers(8, m // 2 + 1)),
                  int(rng.integers(8, m // 2 + 1))) for _ in range(9)]
    elif kind == "flush":
        half = m // 2
        sizes = [(half, half)] * 4 + [(m, m), (m - 24, 16), (24, m)]
    else:
        sizes = []
    patches = [Patch(0, 0, w, h, frame_id=i % 3)
               for i, (w, h) in enumerate(sizes)]
    plan = build_batch_plan(patches, stitch(patches, m, m), m, m)
    jpatches = [JPatch(**dataclasses.asdict(p)) for p in patches]
    jplan = jbuild(jpatches, jstitch(jpatches, m, m), m, m)
    np.testing.assert_array_equal(plan.records, jplan.records)
    return plan, rng


def _slots(plan, rng, dtype):
    _, _, span = DTYPES[dtype]
    if span is None:
        crops = [rng.normal(size=(h, w, 3))
                 for _, _, _, _, w, h in plan.placements()]
    else:
        crops = [rng.integers(*span, size=(h, w, 3))
                 for _, _, _, _, w, h in plan.placements()]
    # placements() is canvas order; slots are queue order
    order = [slot for _, slot, *_ in plan.placements()]
    by_slot = [None] * plan.num_patches
    for slot, crop in zip(order, crops):
        by_slot[slot] = np.asarray(crop, np.float32)
    host = ops.pack_plan_host(by_slot, plan)
    # fill the slot padding too: only the (h, w) region may be copied
    host = np.where(host == 0, np.float32(7), host) if span is None else \
        host
    return host


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.mark.parametrize("kind", ["random", "flush", "empty"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_versions_match_reference_and_pallas(kind, dtype):
    m = 128
    plan, rng = _plan(kind, m, seed=7)
    host = _slots(plan, rng, dtype)
    jdt, tdt, _ = DTYPES[dtype]
    jslots, jrec = jnp.asarray(host, jdt), jnp.asarray(plan.records)
    tslots, trec = torch.from_numpy(host).to(tdt), torch.from_numpy(
        plan.records)

    canv = ops.stitch_canvases(tslots, trec, m, m)      # CPU -> plain
    assert canv.dtype == tdt and canv.shape == (plan.num_canvases, m, m, 3)
    want = _to_numpy(stitch_reference(jslots, jrec, m, m))
    np.testing.assert_array_equal(_to_numpy(canv), want)
    np.testing.assert_array_equal(
        _to_numpy(stitch_pallas(jslots, jrec, m, m, interpret=True)), want)

    cap, hmax, wmax = plan.slot_capacity, plan.hmax, plan.wmax
    back = ops.unstitch_patches(canv, trec, cap, hmax, wmax)
    assert back.dtype == tdt and back.shape == (cap, hmax, wmax, 3)
    jcanv = jnp.asarray(want, jdt)
    np.testing.assert_array_equal(
        _to_numpy(back), _to_numpy(unstitch_reference(jcanv, jrec, cap,
                                                      hmax, wmax)))
    live = plan.num_patches
    pallas = unstitch_pallas(jcanv, jrec, cap, hmax, wmax, interpret=True)
    np.testing.assert_array_equal(_to_numpy(back)[:live],
                                  _to_numpy(pallas)[:live])
    # round trip: each slot's (h, w) region comes back, padding zeroed
    for _, slot, _, _, w, h in plan.placements():
        np.testing.assert_array_equal(_to_numpy(back[slot, :h, :w]),
                                      _to_numpy(tslots[slot, :h, :w]))
        assert not _to_numpy(back[slot])[h:].any()
        assert not _to_numpy(back[slot])[:, w:].any()
    assert not _to_numpy(back)[live:].any()


def test_empty_batch_shapes():
    slots = torch.zeros((0, 8, 8, 3))
    records = torch.zeros((0, 4, 6), dtype=torch.int32)
    canv = ops.stitch_canvases(slots, records, 64, 64)
    assert canv.shape == (0, 64, 64, 3)
    back = ops.unstitch_patches(canv, records, 0, 8, 8)
    assert back.shape == (0, 8, 8, 3)


def test_cuda_impl_on_cpu_tensor_raises():
    plan, rng = _plan("random", 64, seed=1)
    tslots = torch.from_numpy(_slots(plan, rng, "float32"))
    trec = torch.from_numpy(plan.records)
    with pytest.raises(ValueError, match="CUDA"):
        ops.stitch_canvases(tslots, trec, 64, 64, impl="cuda")
    canv = ops.stitch_canvases(tslots, trec, 64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ops.unstitch_patches(canv, trec, plan.slot_capacity, plan.hmax,
                             plan.wmax, impl="cuda")
    with pytest.raises(ValueError, match="unknown stitch impl"):
        ops.stitch_canvases(tslots, trec, 64, 64, impl="pallas")


def test_check_records_rejects_out_of_contract_plans():
    plan, _ = _plan("random", 64, seed=2)
    ops.check_records(plan)
    bad = plan.records.copy()
    bad[0, 0, 2] = 64 - bad[0, 0, 4] + 1        # spills past the right edge
    with pytest.raises(ValueError, match="contract"):
        ops.check_records(dataclasses.replace(plan, records=bad))
    bad = plan.records.copy()
    bad[0, 0, 1] = plan.slot_capacity             # slot out of range
    with pytest.raises(ValueError, match="contract"):
        ops.check_records(dataclasses.replace(plan, records=bad))


def test_pack_plan_host_matches_reference():
    plan, rng = _plan("random", 128, seed=3)
    crops = [rng.normal(size=(p[5], p[4], 3)).astype(np.float32)
             for p in sorted(plan.placements(), key=lambda r: r[1])]
    jpatches = [JPatch(0, 0, c.shape[1], c.shape[0]) for c in crops]
    jplan = jbuild(jpatches, jstitch(jpatches, 128, 128), 128, 128)
    np.testing.assert_array_equal(ops.pack_plan_host(crops, plan),
                                  jops.pack_plan_host(crops, jplan))


def _overlapping_records(rng, b, k, m, n, hmax, wmax, p):
    """(B, K, 6) records placed at random inside the canvas, overlapping
    one another, about one in five invalid, slots drawn with repeats."""
    w = rng.integers(1, wmax + 1, size=(b, k))
    h = rng.integers(1, hmax + 1, size=(b, k))
    x = rng.integers(0, n - w + 1)
    y = rng.integers(0, m - h + 1)
    valid = (rng.random((b, k)) < 0.8).astype(np.int64)
    slot = rng.integers(0, p, size=(b, k))
    return np.stack([valid, slot, x, y, w, h], axis=-1).astype(np.int32)


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_overlapping_placements_last_record_wins(dtype, c):
    """Where placements overlap, the plain K1, the JAX oracle and the
    Pallas kernel (interpret mode) all keep the last valid record's pixel
    in k order; K1 on the card is held to the same answer."""
    rng = np.random.default_rng(17)
    m, n, hmax, wmax, p = 40, 56, 24, 32, 5
    records = _overlapping_records(rng, 2, 9, m, n, hmax, wmax, p)
    _, _, span = DTYPES[dtype]
    if span is None:
        host = rng.normal(size=(p, hmax, wmax, c)).astype(np.float32)
    else:
        host = rng.integers(*span, size=(p, hmax, wmax, c)).astype(
            np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    got = ops.stitch_canvases(torch.from_numpy(host).to(tdt),
                              torch.from_numpy(records), m, n)
    jslots, jrec = jnp.asarray(host, jdt), jnp.asarray(records)
    want = _to_numpy(stitch_reference(jslots, jrec, m, n))
    np.testing.assert_array_equal(_to_numpy(got), want)
    np.testing.assert_array_equal(
        _to_numpy(stitch_pallas(jslots, jrec, m, n, interpret=True)), want)
    # the overlap is real, and its pixels come from the later record
    canvas = _to_numpy(got)[0]
    ks = [i for i in range(9) if records[0, i, 0]]
    hit = 0
    for a in ks:
        for z in ks:
            if z <= a:
                continue
            _, sa, xa, ya, wa, ha = records[0, a]
            _, sz, xz, yz, wz, hz = records[0, z]
            x0, x1 = max(xa, xz), min(xa + wa, xz + wz)
            y0, y1 = max(ya, yz), min(ya + ha, yz + hz)
            if x0 < x1 and y0 < y1 and not any(
                    records[0, q, 0] and records[0, q, 2] < x1
                    and records[0, q, 2] + records[0, q, 4] > x0
                    and records[0, q, 3] < y1
                    and records[0, q, 3] + records[0, q, 5] > y0
                    for q in range(z + 1, 9)):
                hit += 1
                np.testing.assert_array_equal(
                    canvas[y0:y1, x0:x1],
                    _to_numpy(torch.from_numpy(host).to(tdt))[
                        sz, y0 - yz:y1 - yz, x0 - xz:x1 - xz])
    assert hit > 0
