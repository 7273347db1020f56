"""The port's serving and training examples (``examples/torch_serve_e2e.py``,
``examples/torch_train_detector.py``) run on the CPU, against the JAX
examples they port, each run as its own script.

Required: the serving example's summary line equal to the JAX example's
on the same detector weights (the JAX driver's, converted:
``test_torch_serve.jax_weights``) in patches served, invocations, routed
detections, MB of patch evidence and frames held (0); SLO violations
follow each host's profiled latency table and are not compared.  The
training example learns (its own assertion) and restores at its drill;
with too few steps for a checkpoint before the drill, both examples
stop with the same message.
"""
import runpy
import sys

import pytest

from test_torch_cuda import EXAMPLES, load_example
from test_torch_serve import _assert_same_summary, _summary, jax_weights  # noqa: F401,E501


def test_serve_example_matches_jax_example(jax_weights, capsys):  # noqa: F811
    runpy.run_path(str(EXAMPLES / "serve_e2e.py"),
                   run_name="__main__")
    want = _summary(capsys.readouterr().out)
    load_example("torch_serve_e2e").main(["--device", "cpu"])
    out = capsys.readouterr().out
    got = _summary(out)
    _assert_same_summary(got, want)
    assert got[0] > 0 and got[2] > 0
    assert "device: cpu" in out


def test_serve_example_passes_its_driver_arguments(capsys):
    """The example's own arguments reach the driver, and a caller's come
    after them (the later flag wins)."""
    mod = load_example("torch_serve_e2e")
    mod.main(["--device", "cpu", "--frames", "2"])
    got = _summary(capsys.readouterr().out)
    assert got[:2] == (0, 0)              # the zero-patch path
    assert mod.ARGS == ["--frames", "40", "--canvas", "192", "--slo", "2.0",
                        "--use-pallas-stitch"]


def test_train_example_learns_and_restores(capsys):
    losses, drills = load_example("torch_train_detector").main(
        ["--device", "cpu", "--steps", "44"])
    out = capsys.readouterr().out
    assert len(losses) == 44 and drills == 1
    assert "[drill] host at step 22: restoring latest checkpoint" in out
    assert "detector training learns + survives the failure drill" in out


@pytest.mark.parametrize("example,error", [
    ("train_detector", AssertionError), ("torch_train_detector", RuntimeError)])
def test_train_examples_raise_without_a_checkpoint(example, error,
                                                   monkeypatch, capsys):
    """At 12 steps the drill fires at step 6, before the first checkpoint
    (step 20): both examples stop with the same message (the JAX driver
    asserts, the port's raises a ``RuntimeError``, which ``python -O``
    does not strip)."""
    argv = ["--steps", "12"]
    if example.startswith("torch_"):
        argv += ["--device", "cpu"]
    monkeypatch.setattr(sys, "argv", [f"{example}.py"] + argv)
    with pytest.raises(error, match="no checkpoint to recover from"):
        runpy.run_path(str(EXAMPLES / f"{example}.py"),
                       run_name="__main__")
    out = capsys.readouterr().out
    assert "[drill] host at step 6: restoring latest checkpoint" in out
