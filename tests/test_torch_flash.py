"""The port's flash attention (K6) and flash decode (K7) entries on the CPU,
where they run their plain versions, against the JAX package's Pallas
kernels in interpret mode and its jnp oracles, on the cases of
``tests/test_kernels.py`` plus ragged lengths the Pallas kernels cannot
take (S = 197, the ViT-B/16 token count).

Tolerances: 2e-5 in float32 (summation order differs between XLA and
PyTorch's CPU einsums); 2e-2 in bfloat16 (the plain version rounds the
normalised probabilities to bf16, the Pallas kernel the unnormalised
ones, as ``tests/test_kernels.py`` allows).  On a CUDA tensor the same
entries launch the kernels; ``tests/test_torch_cuda.py`` holds those
against the plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as jops
from repro.kernels.attention.ref import decode_reference, mha_reference
from repro.models import attention as jattn
from repro.sharding import ShardingConfig
from repro_torch.kernels.attention import flash as tflash
from repro_torch.kernels.attention import ops as tops
from repro_torch.models import attention as tattn

JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

ATTN_CASES = [
    # (B, S, H, Kv, D, causal, dtype, bq, bk, segments)
    (1, 128, 4, 4, 64, True, "float32", 64, 64, False),
    (2, 256, 8, 2, 64, True, "float32", 128, 64, False),
    (2, 256, 8, 8, 32, False, "float32", 64, 128, False),
    (1, 512, 4, 1, 128, True, "float32", 128, 128, False),
    (2, 128, 4, 4, 64, True, "bfloat16", 64, 64, False),
    (2, 256, 4, 4, 64, True, "float32", 64, 64, True),
    (2, 256, 6, 2, 64, True, "bfloat16", 64, 64, True),
    # ragged: one Pallas block of the whole length
    (2, 197, 12, 12, 64, False, "float32", 197, 197, False),
    (1, 197, 6, 2, 32, True, "bfloat16", 197, 197, False),
    # head dims outside K6's wgmma set: DiT-XL/2's 72, the reduced
    # configs' 16
    (2, 64, 4, 4, 72, False, "float32", 64, 64, False),
    (2, 128, 4, 4, 72, False, "bfloat16", 64, 64, False),
    (2, 64, 4, 4, 16, False, "float32", 32, 32, False),
]


def _inputs(rng, shapes, dtype):
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, JDTYPES[dtype]) for a in arrays],
            [torch.from_numpy(a).to(TDTYPES[dtype]) for a in arrays])


def _segments(b, s):
    # four requests of uneven length: whole 64-row tiles of the first are
    # masked for the rows of the last
    cuts = np.array([0, s // 8, s // 2, (7 * s) // 8, s])
    seg = np.zeros((b, s), np.int32)
    for i in range(4):
        seg[:, cuts[i]:cuts[i + 1]] = i
    return seg


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,s,h,kv,d,causal,dtype,bq,bk,segments",
                         ATTN_CASES)
def test_flash_attention_plain_matches_jax(b, s, h, kv, d, causal, dtype, bq,
                                           bk, segments):
    rng = np.random.default_rng(0)
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        rng, [(b, s, h, d), (b, s, kv, d), (b, s, kv, d)], dtype)
    seg = _segments(b, s) if segments else None
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)
    got = tops.flash_attention(tq, tk, tv, causal=causal, segment_ids=tseg)
    assert got.shape == (b, s, h, d) and got.dtype == TDTYPES[dtype]
    _close(got, mha_reference(jq, jk, jv, causal=causal, segment_ids=jseg),
           dtype)
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                     segment_ids=jseg, block_q=bq,
                                     block_kv=bk, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 1, 63, 64, 200, 511])
@pytest.mark.parametrize("kv", [1, 4])
def test_flash_decode_plain_matches_jax(pos, kv, dtype):
    rng = np.random.default_rng(2)
    b, h, d, smax = 2, 8, 64, 512
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        rng, [(b, 1, h, d), (b, smax, kv, d), (b, smax, kv, d)], dtype)
    got = tops.flash_decode(tq, tk, tv, pos)
    assert got.shape == (b, 1, h, d) and got.dtype == TDTYPES[dtype]
    _close(got, decode_reference(jq, jk, jv, pos), dtype)
    _close(got, jops.flash_decode(jq, jk, jv, pos, block_kv=128,
                                  interpret=True), dtype)


def test_impl_follows_the_device_and_never_falls_back():
    q = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.flash_decode(q[:, :1], q, q, 3, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        tops.flash_attention(q, q, q, impl="pallas")
    assert tops.resolve_impl(None, q) == "torch"
    # the kernel wrappers refuse a CPU tensor before building anything
    with pytest.raises(ValueError, match="CUDA device"):
        tflash.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA device"):
        tflash.flash_decode_cuda(q[:, :1], q, q, 0)


@pytest.mark.parametrize("n_valid,pairs,sms,chunk", [
    (1, 16, 132, 64),          # pos 0: one chunk of one block pass
    (512, 16, 132, 64),        # pos 511 at B=2, Kv=8: 8 chunks x 16
    (4096, 16, 132, 512),      # pos 4095: 8 chunks x 16 = 128 blocks
    (32768, 64, 132, 16384),   # B=8 at 32k: 2 chunks x 64 pairs
])
def test_decode_chunk_spreads_the_cache_over_the_card(n_valid, pairs, sms,
                                                      chunk):
    """K7's chunk of positions (``decode_chunk`` at the chunks of
    ``decode_plan``) at minitron-4b's 8 KV heads, in a cache of
    ``n_valid`` positions and in one of 32,768: a multiple of the block's
    64-position pass, as many chunks a (batch, KV head) as give about one
    block an SM, at most 8, whatever the cache beyond pos."""
    for smax in (n_valid, 32768):
        plan = tflash.decode_plan(pairs // 8, smax, 24, 8, 128,
                                  torch.bfloat16, sms)
        assert tflash.decode_chunk(n_valid - 1, plan.grid[0]) == chunk
        assert chunk % 64 == 0
        assert plan.grid[0] * pairs <= sms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 1, 63, 64, 200, 511])
def test_flash_decode_plain_takes_a_tensor_pos(pos, dtype):
    """The plain K7 with ``pos`` a 0-d int32 tensor (the port's device
    position) against the Pallas kernel in interpret mode with
    ``jnp.int32(pos)`` (its SMEM scalar), GQA 8 over 4, and bit-equal to
    the plain K7 at the host int."""
    rng = np.random.default_rng(3)
    b, h, kv, d, smax = 2, 8, 4, 64, 512
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        rng, [(b, 1, h, d), (b, smax, kv, d), (b, smax, kv, d)], dtype)
    got = tops.flash_decode(tq, tk, tv, torch.tensor(pos, dtype=torch.int32))
    assert torch.equal(got, tops.flash_decode(tq, tk, tv, pos))
    _close(got, jops.flash_decode(jq, jk, jv, jnp.int32(pos), block_kv=128,
                                  interpret=True), dtype)


@pytest.mark.parametrize("jimpl", ["xla", "flash_interpret"])
@pytest.mark.parametrize("impl", ["xla", "flash", "torch"])
def test_encoder_attention_flash_option_matches_jax(impl, jimpl):
    """The ViT encoder's attention: the port's plain path, its K6 option
    (its plain version on the CPU) and K6's plain version asked by name
    against the JAX package's XLA path and its Pallas kernel in interpret
    mode, float32."""
    rng = np.random.default_rng(4)
    d, h, dh = 64, 4, 16
    w = {k: rng.normal(size=s).astype(np.float32) / np.sqrt(d)
         for k, s in (("wq", (d, h, dh)), ("wk", (d, h, dh)),
                      ("wv", (d, h, dh)), ("wo", (h, dh, d)))}
    x = rng.normal(size=(2, 64, d)).astype(np.float32)
    want = jattn.encoder_attention(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        n_heads=h, compute_dtype=jnp.float32,
        rules=ShardingConfig.make().rules, impl=jimpl)
    got = tattn.encoder_attention(
        {k: torch.from_numpy(v) for k, v in w.items()}, torch.from_numpy(x),
        compute_dtype=torch.float32, impl=impl)
    _close(got, want, "float32")
