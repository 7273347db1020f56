"""The port's sequence packing against the JAX package's module: the same
requests give the same rows, spans, mask blocks and efficiency, and the
packer fires through the port's SLO-aware invoker as the reference's does
through its own.  ``segment_ids`` (the port's bridge to K6's segment
masking) is checked against the spans."""
import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import sequence_packing as jsp
from repro.core.latency import LatencyTable as JLatencyTable
from repro_torch.core import sequence_packing as tsp
from repro_torch.core.latency import LatencyTable


def reqs(mod, lengths, slo=1.0):
    return [mod.Request(n, t_gen=0.0, slo=slo, request_id=i)
            for i, n in enumerate(lengths)]


def rows_of(rows):
    return [(r.seq_len, list(r.spans)) for r in rows]


@pytest.mark.parametrize("lengths,seq_len", [
    ([700, 200, 300], 1024),
    ([700, 200, 300, 100], 1024),
    ([100, 200], 512),
    ([4096], 4096),
    ([], 1024),
])
def test_pack_matches_reference(lengths, seq_len):
    got = tsp.pack(reqs(tsp, lengths), seq_len)
    want = jsp.pack(reqs(jsp, lengths), seq_len)
    assert rows_of(got) == rows_of(want)
    assert tsp.attention_mask_blocks(got) == jsp.attention_mask_blocks(want)
    assert tsp.packing_efficiency(got) == jsp.packing_efficiency(want)
    assert [r.free for r in got] == [r.free for r in want]


def test_best_fit_and_oversized_as_reference():
    rows = tsp.pack(reqs(tsp, [700, 200, 300, 100]), 1024)
    assert [r.used for r in rows] == [1000, 300]
    for mod in (tsp, jsp):
        with pytest.raises(ValueError):
            mod.pack(reqs(mod, [2000]), 1024)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.integers(1, 1024), min_size=1, max_size=50))
def test_pack_invariants_and_reference(lengths):
    rows = tsp.pack(reqs(tsp, lengths), 1024)
    assert rows_of(rows) == rows_of(jsp.pack(reqs(jsp, lengths), 1024))
    seen = []
    for row in rows:
        pos = 0
        for idx, s, e in row.spans:
            assert s == pos and e <= 1024
            pos = e
            seen.append(idx)
    assert sorted(seen) == list(range(len(lengths)))
    assert len(rows) >= math.ceil(sum(lengths) / 1024)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(1, 512), min_size=1, max_size=30))
def test_segment_ids_follow_the_spans(lengths):
    rows = tsp.pack(reqs(tsp, lengths), 512)
    seg = tsp.segment_ids(rows)
    assert seg.shape == (len(rows), 512) and seg.dtype == np.int32
    for i, blocks in enumerate(tsp.attention_mask_blocks(rows)):
        for j, (s, e) in enumerate(blocks):
            assert (seg[i, s:e] == j).all()
        tail = seg[i, rows[i].used:]
        assert (tail == len(blocks)).all()


def test_sequence_packer_fires_as_the_reference():
    table = {b: (0.05 * b, 0.005) for b in range(1, 65)}
    got = tsp.SequencePacker(1024, LatencyTable(dict(table)))
    want = jsp.SequencePacker(1024, JLatencyTable(dict(table)))
    for t, (n, i) in zip((0.0, 0.1), ((600, 0), (300, 1))):
        assert got.on_request(t, tsp.Request(n, t, 1.0, i)) == []
        assert want.on_request(t, jsp.Request(n, t, 1.0, i)) == []
    assert got.next_timer() == pytest.approx(want.next_timer())
    t = got.next_timer()
    assert 0 < t < 1.0
    inv, ref = got.poll(t), want.poll(t)
    assert inv is not None and ref is not None
    assert len(inv.patches) == len(ref.patches) == 2
    assert inv.batch_size == ref.batch_size == 1
