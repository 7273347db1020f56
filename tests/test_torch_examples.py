"""The port's quickstart and LM sequence-packing examples
(``examples/torch_quickstart.py``, ``examples/torch_lm_sequence_packing.py``)
against the JAX examples they port, on the CPU.

Each JAX example runs unchanged as its own file does (the LM's Pallas
flash kernel in interpret mode), with the calls whose results the port
must reproduce recorded on the way.  Required:

- quickstart: the port's edge stream equal, patch for patch, to the JAX
  example's; the port's cloud report on the JAX example's latency table
  equal to the JAX report (``summary()`` and canvases per invocation
  exactly, and the printed lines);
- LM: the printed packing, invoker and shape lines equal; with the JAX
  example's weights (``convert_params``) its tokens and segment ids equal
  and its hidden states and segment-masked attention output within 1e-4
  (absolute and relative, float32: XLA and PyTorch's CPU matmuls sum in
  different orders).
"""
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro_torch.core.latency import LatencyTable
from repro_torch.models import transformer as ttr
from test_torch_cuda import load_example

TOL = 1e-4


def _patch_fields(p) -> tuple:
    return tuple(getattr(p, f.name) for f in dataclasses.fields(p))


@pytest.fixture(scope="module")
def jax_quickstart():
    """The JAX quickstart's run: its stream, latency table, results and
    printed text."""
    mod = load_example("quickstart")
    seen = {}

    class Recording(mod.TangramScheduler):
        def __init__(self, m, n, table, platform, **kw):
            seen["table"] = table
            super().__init__(m, n, table, platform, **kw)

        def run(self, streams, **kw):
            seen["stream"] = list(streams[0])
            seen["res"] = super().run(streams, **kw)
            return seen["res"]

    mod.TangramScheduler = Recording      # this module object's name only
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    seen["text"] = out.getvalue()
    return seen


@pytest.fixture(scope="module")
def port_quickstart():
    return load_example("torch_quickstart")


def test_quickstart_edge_stream_equals_jax_example(jax_quickstart,
                                                   port_quickstart):
    stream, n_frames = port_quickstart.edge_stream("cpu")
    want = [_patch_fields(p) for p in jax_quickstart["stream"]]
    assert n_frames == 40
    assert len(want) > 0
    assert [_patch_fields(p) for p in stream] == want


def test_quickstart_cloud_report_equals_jax_example(jax_quickstart,
                                                    port_quickstart,
                                                    capsys):
    stream, _ = port_quickstart.edge_stream("cpu")
    jtable = jax_quickstart["table"]
    table = LatencyTable(dict(jtable.table),
                         slack_sigmas=jtable.slack_sigmas)
    res = port_quickstart.cloud_report(stream, table)
    want = jax_quickstart["res"]
    assert res.summary() == want.summary()
    assert np.mean(res.batch_sizes) == np.mean(want.batch_sizes)
    report = capsys.readouterr().out
    assert report.strip() and report in jax_quickstart["text"]


def test_quickstart_main_prints_the_edge_line(jax_quickstart,
                                              port_quickstart, capsys):
    """The whole example on the CPU: its own (one-H100) latency table,
    the JAX example's edge line."""
    stream, res = port_quickstart.main(["--device", "cpu"])
    first = capsys.readouterr().out.splitlines()[0]
    assert first == jax_quickstart["text"].splitlines()[0]
    assert res.summary()["patches"] == len(stream)


@pytest.fixture(scope="module")
def jax_lm():
    """The JAX LM example's run: its weights, tokens, segment ids, hidden
    states, segment-masked attention output and printed text."""
    mod = load_example("lm_sequence_packing")
    seen = {}
    init = mod.param_lib.init_params
    forward = mod.tfm.forward
    flash = mod.attn_ops.flash_attention

    def rec_init(*a, **kw):
        seen["params"] = init(*a, **kw)
        return seen["params"]

    def rec_forward(cfg, params, tokens, *a, **kw):
        seen["cfg"], seen["tokens"] = cfg, tokens
        seen["hidden"] = forward(cfg, params, tokens, *a, **kw)[0]
        return seen["hidden"], None

    def rec_flash(*a, **kw):
        seen["segment_ids"] = kw["segment_ids"]
        seen["attention"] = flash(*a, **kw)
        return seen["attention"]

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(mod.param_lib, "init_params", rec_init)
        mp.setattr(mod.tfm, "forward", rec_forward)
        mp.setattr(mod.attn_ops, "flash_attention", rec_flash)
        mod.main()
    seen["text"] = out.getvalue()
    return seen


@pytest.fixture(scope="module")
def port_lm_on_jax_weights(jax_lm):
    """The port's example on the JAX example's weights: (its returns, its
    printed text)."""
    mod = load_example("torch_lm_sequence_packing")
    params = ttr.convert_params(
        jax.tree_util.tree_map(np.asarray, jax_lm["params"]), mod.CFG,
        torch.device("cpu"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = mod.main(["--device", "cpu"], params=params)
    return got, out.getvalue()


def test_lm_example_prints_the_jax_example_lines(jax_lm,
                                                 port_lm_on_jax_weights):
    text = port_lm_on_jax_weights[1]
    assert len(text.splitlines()) == 3
    assert text == jax_lm["text"]


def test_lm_example_serves_the_jax_example_row(jax_lm,
                                               port_lm_on_jax_weights):
    got = port_lm_on_jax_weights[0]
    assert np.array_equal(got["tokens"].numpy(), np.asarray(jax_lm["tokens"]))
    seg = got["segment_ids"].numpy()
    assert np.array_equal(seg, np.asarray(jax_lm["segment_ids"]))
    assert seg.max() > 1                  # the row packs several requests


@pytest.mark.parametrize("what", ["hidden", "attention"])
def test_lm_example_outputs_match_jax_example(jax_lm, port_lm_on_jax_weights,
                                              what):
    got = port_lm_on_jax_weights[0][what].numpy()
    want = np.asarray(jax_lm[what], np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_lm_example_config_is_the_jax_example_config(jax_lm):
    mod = load_example("torch_lm_sequence_packing")
    jcfg = jax_lm["cfg"]
    for f in dataclasses.fields(mod.CFG):
        if hasattr(jcfg, f.name) and f.name != "cache_update":
            assert getattr(mod.CFG, f.name) == getattr(jcfg, f.name), f.name


def test_lm_example_seeded_weights_run_on_the_cpu(capsys):
    """The example as a user runs it (seeded weights): finite outputs of
    the printed shapes, the same on a second run."""
    mod = load_example("torch_lm_sequence_packing")
    a = mod.main(["--device", "cpu"])
    b = mod.main(["--device", "cpu"])
    assert tuple(a["hidden"].shape) == (1, mod.SEQ, mod.CFG.d_model)
    assert tuple(a["attention"].shape) == (1, mod.SEQ, 4, 32)
    assert torch.isfinite(a["hidden"]).all()
    assert torch.equal(a["hidden"], b["hidden"])
    assert "packed-forward OK" in capsys.readouterr().out
