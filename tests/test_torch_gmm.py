"""K5, the GMM background update: the port's plain PyTorch version (what a
CPU tensor runs, and what the hand-written kernel is held against bit for
bit on the card) against the JAX package's Pallas kernel in interpret mode
and its XLA path, on the same numpy inputs (seed 7).

The mixture state is compared within 1e-6 abs and the foreground masks
exactly: both packages evaluate the same float32 elementwise expressions.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gmm as jgmm
from repro.kernels.gmm import ops as jops
from repro_torch.core import gmm as tgmm
from repro_torch.kernels.gmm import gmm as kernel
from repro_torch.kernels.gmm import ops
from repro_torch.kernels.launches import LAUNCHES
from repro_torch.sources.camera import EdgePipeline

KEYS = ("w", "mu", "var")


def _port_state(jstate):
    return ops.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                                device="cpu")


def _assert_state_close(tstate, jstate, tfg, jfg):
    for key in KEYS:
        np.testing.assert_allclose(tstate[key].numpy(),
                                   np.asarray(jstate[key]), atol=1e-6)
    assert tfg.dtype == torch.bool
    np.testing.assert_array_equal(tfg.numpy(), np.asarray(jfg))


def _tie_state(h, w):
    """States full of ties, cycling over the pixels: equal weights with
    x == mu (every component matches, equal fitness), equal weights with x
    far away (nothing matches, equal weights to replace), a 2-way fitness
    tie behind a heavier component, and equal weights with x == mu but
    unequal variances."""
    n = h * w
    kind = np.arange(n) % 4
    x = np.linspace(0.1, 0.9, n, dtype=np.float32)
    third = np.float32(1.0) / np.float32(3.0)
    wt = np.full((n, 3), third, np.float32)
    mu = np.repeat(x[:, None], 3, axis=1)
    var = np.full((n, 3), 0.04, np.float32)
    far = kind == 1
    mu[far] = np.clip(x[far, None] + 0.6, 0, 1.5) % 1.0 + 2.0
    heavy = kind == 2
    wt[heavy] = np.array([0.5, 0.25, 0.25], np.float32)
    mu[heavy, 0] = x[heavy] + 0.6
    spread = kind == 3
    var[spread] = np.array([0.04, 0.01, 0.09], np.float32)
    state = {"w": wt.reshape(h, w, 3), "mu": mu.reshape(h, w, 3),
             "var": var.reshape(h, w, 3)}
    return state, x.reshape(h, w)


@pytest.mark.parametrize("h,w,bh,bw", [(8, 128, 8, 128), (16, 256, 8, 128),
                                       (32, 512, 8, 256)])
def test_plain_matches_pallas_interpret(h, w, bh, bw):
    rng = np.random.default_rng(7)
    jstate = jgmm.init_state(h, w)
    tstate = _port_state(jstate)
    for _ in range(4):
        frame = rng.random((h, w)).astype(np.float32)
        jstate, jfg = jops.gmm_update(jstate, jnp.asarray(frame),
                                      impl="pallas_interpret", block_h=bh,
                                      block_w=bw)
        tstate, tfg = ops.gmm_update(tstate, torch.from_numpy(frame))
        _assert_state_close(tstate, jstate, tfg, jfg)


@pytest.mark.parametrize("h,w", [(1, 1), (27, 45), (135, 240)])
def test_plain_matches_xla_on_shapes_pallas_refuses(h, w):
    """Shapes that are not multiples of the Pallas kernel's (8, 512)
    blocks, which K5 on the card takes; state carried over 6 frames, half
    of each near the components' means so that matches occur."""
    rng = np.random.default_rng(7)
    jstate = jgmm.init_state(h, w)
    tstate = _port_state(jstate)
    base = rng.random((h, w)).astype(np.float32)
    for i in range(6):
        noise = rng.normal(0, 0.02, (h, w)).astype(np.float32)
        frame = np.where(rng.random((h, w)) < 0.5, base + noise,
                         rng.random((h, w))).astype(np.float32)
        jstate, jfg = jops.gmm_update(jstate, jnp.asarray(frame), impl="xla")
        tstate, tfg = ops.gmm_update(tstate, torch.from_numpy(frame),
                                     impl="torch")
        _assert_state_close(tstate, jstate, tfg, jfg)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_tie_laden_state_matches_jax(impl):
    state, x = _tie_state(8, 128)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    jstate, jfg = jops.gmm_update(jstate, jnp.asarray(x), impl=impl,
                                  block_h=8, block_w=128)
    tstate, tfg = ops.gmm_update(ops.state_from_numpy(state, "cpu"),
                                 torch.from_numpy(x))
    _assert_state_close(tstate, jstate, tfg, jfg)
    w = tstate["w"].reshape(-1, 3).numpy()
    kind = np.arange(w.shape[0]) % 4
    # all equal and matched: the first component wins the fitness tie
    assert (w[kind == 0, 0] > w[kind == 0, 1]).all()
    np.testing.assert_array_equal(w[kind == 0, 1], w[kind == 0, 2])
    # nothing matched and equal weights: the first component is replaced
    np.testing.assert_array_equal(
        tstate["mu"].reshape(-1, 3).numpy()[kind == 1, 0],
        x.ravel()[kind == 1])
    # the 2-way tie behind the unmatched heavy component goes to index 1
    assert (w[kind == 2, 1] > w[kind == 2, 2]).all()


def test_background_convergence():
    """Static background absorbed; moving object flagged as foreground."""
    h, w = 16, 128
    state = tgmm.init_state(h, w, device="cpu")
    bg = torch.full((h, w), 0.5)
    for _ in range(30):
        state, fg = ops.gmm_update(state, bg)
    assert int(fg.sum()) == 0
    frame = bg.clone()
    frame[4:8, 10:30] = 0.95
    _, fg = ops.gmm_update(state, frame)
    assert int(fg[4:8, 10:30].sum()) >= 0.9 * (4 * 20)
    assert int(fg.sum()) <= 4 * 20 * 1.5


def test_warmup_matches_jax_scan():
    rng = np.random.default_rng(7)
    frames = rng.random((5, 16, 24)).astype(np.float32)
    jstate, jmasks = jgmm.warmup(jgmm.init_state(16, 24), jnp.asarray(frames))
    tstate, tmasks = tgmm.warmup(tgmm.init_state(16, 24, device="cpu"),
                                 torch.from_numpy(frames))
    assert tmasks.shape == (5, 16, 24)
    _assert_state_close(tstate, jstate, tmasks, jmasks)


def test_fold_sums_agree_with_torch_sum_on_the_cpu():
    """The plain version's index-order folds give what ``torch.sum`` gives
    on the CPU, so the state is the one the port computed before them."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random((64, 64, 3)).astype(np.float32))
    assert torch.equal(tgmm._fold_sum(x), x.sum(dim=-1))


def test_impl_rules():
    state = tgmm.init_state(4, 8, device="cpu")
    frame = torch.full((4, 8), 0.3)
    before = dict(LAUNCHES)
    new, fg = ops.gmm_update(state, frame)                 # CPU -> plain
    ref, ref_fg = ops.gmm_update(state, frame, impl="torch")
    assert all(torch.equal(new[k], ref[k]) for k in KEYS)
    assert torch.equal(fg, ref_fg)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.gmm_update(state, frame, impl="cuda")
    with pytest.raises(ValueError, match="unknown gmm impl"):
        ops.gmm_update(state, frame, impl="pallas")
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.gmm_update_cuda(state, frame)              # never falls back


def test_edge_pipeline_checks_gmm_impl_at_construction():
    assert EdgePipeline(8, 16, canvas=8, device="cpu").gmm_impl == "torch"
    with pytest.raises(ValueError, match="CUDA tensor"):
        EdgePipeline(8, 16, canvas=8, device="cpu", gmm_impl="cuda")
    with pytest.raises(ValueError, match="unknown gmm impl"):
        EdgePipeline(8, 16, canvas=8, device="cpu", gmm_impl="xla")


def test_state_from_numpy_round_trip():
    jstate = jgmm.init_state(3, 5)
    state = ops.state_from_numpy({k: np.asarray(v)
                                  for k, v in jstate.items()}, "cpu")
    for key in KEYS:
        assert state[key].dtype == torch.float32
        assert state[key].is_contiguous()
        np.testing.assert_array_equal(state[key].numpy(),
                                      np.asarray(jstate[key]))
