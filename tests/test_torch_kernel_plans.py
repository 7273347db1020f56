"""Host-side launch planning of K1 (stitch), of the wgmma kernels (K4
stitch->embed, K6 flash attention) and of K7's clusters (flash decode),
held against a direct computation on the CPU: the grid covers every
canvas row, token, column, query row and cache position exactly once, K1's
stores tile every canvas row, and the shared memory a block asks for is
the sum of its parts and fits the card.  The kernels themselves run only
on a card (tests/test_torch_cuda.py)."""
import math

import pytest
import torch

from repro_torch.kernels.attention import flash
from repro_torch.kernels.stitch import fused_embed
from repro_torch.kernels.stitch import stitch as stitch_kernels

SMEM_LIMIT = 232448     # bytes of shared memory a Hopper block may use


def test_stitch_plan_main_path_numbers():
    """B = 3 canvases of 1024^2 x 3 float32: 16-byte stores of 4-pixel
    groups (48 B), 4 rows a block (768 blocks), an 8 KB owner map, 12 KB
    of record list and offsets, 16 KB of span buffers."""
    assert stitch_kernels.stitch_plan(3, 1024, 1024, 3, 4) == (
        4, 4, 16, 4 * 1024 * 2 + 2048 * 6 + 16 + 8 * 32 * 16 * 4)
    # uint8 and bf16 payloads: 16 and 8 pixels a group, still 48 B
    assert stitch_kernels.stitch_plan(3, 1024, 1024, 3, 1)[1:3] == (16, 16)
    assert stitch_kernels.stitch_plan(3, 1024, 1024, 3, 2)[1:3] == (8, 16)


@pytest.mark.parametrize("elem", [1, 2, 4])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("b,m,n", [(3, 1024, 1024), (1, 96, 160),
                                   (2, 37, 45), (4, 1024, 1023),
                                   (1, 8, 1), (1, 4300, 66), (65535, 8, 8)])
def test_stitch_plan_tiles_every_row(b, m, n, c, elem):
    """Odd widths included: the store is the widest power of two up to 16
    bytes that divides a canvas row's bytes, a group the fewest whole
    pixels whose bytes are a multiple of it (so groups tile each row and
    every store is aligned), rows a block 8 halved while the grid has
    fewer than 4 x 132 blocks, and the shared memory the owner map (rows x
    N rounded up to 8, int16), the live list and its count, a uint32 slot
    offset a record and 8 warps' span buffers of 512 elements."""
    rows, group, store, smem = stitch_kernels.stitch_plan(b, m, n, c, elem)
    row_bytes = n * c * elem
    assert store in (1, 2, 4, 8, 16) and row_bytes % store == 0
    assert store == 16 or row_bytes % (2 * store)
    assert (group * c * elem) % store == 0 and n % group == 0
    assert group == store // math.gcd(c * elem, store)
    assert rows in (1, 2, 4, 8)
    def owner_map(r):
        return r * (-(-n // 8) * 8) * 2

    # halved only while the grid was short of blocks (or the map too big),
    # and no further than that
    rest = 2048 * 6 + 16 + 8 * 512 * elem
    assert rows == 8 or (-(-m // (2 * rows)) * b < 4 * 132
                         or owner_map(2 * rows) + rest > SMEM_LIMIT)
    assert rows == 1 or -(-m // rows) * b >= 4 * 132 or rows == 8
    assert smem == owner_map(rows) + rest <= SMEM_LIMIT


def test_stitch_plan_rejects_rows_past_shared_memory():
    """One row of 110,000 pixels needs a 220,000-byte owner map, past the
    card's 232,448 bytes with the rest of the block (28,688 bytes at
    float32)."""
    with pytest.raises(ValueError, match="shared memory"):
        stitch_kernels.stitch_plan(1, 4, 110_000, 3, 4)
    # 100,000 pixels still fit in one row a block
    assert stitch_kernels.stitch_plan(1, 4, 100_000, 3, 4)[0] == 1


def _k4_smem(k, patch, cols=192):
    stages = 3
    a_tile = 128 * 64 * 2                 # 128 x 64 bf16
    weights = stages * 64 * cols * 2      # 64 x cols bf16 a stage
    table = 128 * patch * 16              # an int4 per token row segment
    records = k * 20
    end = a_tile + weights + table + records
    return -(-end // 8) * 8 + 2 * stages * 8 + 8 + 1024


@pytest.mark.parametrize("b,seq,d,k,patch", [
    (3, 1024, 768, 64, 32),      # the 2048x1024 trace's largest invocation
    (4, 1024, 768, 64, 32),      # the 4K recording's
    (1, 15, 768, 12, 32),        # a 96 x 160 canvas: 15 tokens
    (3, 1024, 768, 2048, 32),    # the most records a canvas may hold
    (2, 4096, 64, 5, 16),
    (4, 4096, 384, 64, 16),      # vit_s16: 64x64 tokens, K 768, d 384
    (4, 4096, 384, 2048, 16),
    (4, 1024, 512, 64, 32),      # efficientnet_b7's trunk: d 512
    (4, 1024, 512, 2048, 32),
])
def test_stitch_embed_wgmma_plan(b, seq, d, k, patch):
    grid, smem = fused_embed.wgmma_plan(b, seq, d, k, patch)
    assert grid[2] == b
    assert (grid[1] - 1) * 128 < seq <= grid[1] * 128
    assert (grid[0] - 1) * 192 < d <= grid[0] * 192
    assert smem == _k4_smem(k, patch) <= SMEM_LIMIT


def test_stitch_embed_wgmma_plan_main_path_numbers():
    """B = 3 canvases of 1024 tokens, d 768, 64 records, patch 32: 4 x 8
    x 3 = 96 blocks, one wave on 132 SMs."""
    grid, smem = fused_embed.wgmma_plan(3, 1024, 768, 64, 32)
    assert grid == (4, 8, 3)
    assert smem == 16384 + 3 * 24576 + 65536 + 1280 + 48 + 8 + 1024


@pytest.mark.parametrize("tile", fused_embed.K4_TILES)
@pytest.mark.parametrize("seq,d,patch", [(1024, 768, 32), (4096, 384, 16),
                                         (1024, 512, 32)])
@pytest.mark.parametrize("k", [64, 2048])
def test_stitch_embed_wgmma_plan_every_tile(tile, seq, d, patch, k):
    """Each tile of ``K4_TILES`` at the registry's three geometries
    (``tangram``, ``vit_s16``, ``efficientnet_b7``), up to 2,048 records a
    canvas: the grid covers every token and column once, the shared
    memory is the sum of its parts (a narrower tile a shorter weight
    ring) and fits the card, and the shape checks pass."""
    tokens, cols = tile
    grid, smem = fused_embed.wgmma_plan(4, seq, d, k, patch, tile)
    assert grid == (-(-d // cols), seq // tokens, 4)
    assert (grid[0] - 1) * cols < d <= grid[0] * cols
    assert smem == _k4_smem(k, patch, cols) <= SMEM_LIMIT
    fused_embed.check_wgmma_shape("stitch_embed", 4, seq, patch * patch * 3,
                                  d, k, patch, 100, tile)


def test_k4_tiles_default_and_refusal():
    """The default tile is today's 128 x 192 (the main path's launch is
    unchanged); the two narrower column tiles are there; any other tile
    raises, in the plan, the shape check and the dispatcher, on any
    device."""
    assert fused_embed.K4_TILES[0] == (128, 192)
    assert {(128, 128), (128, 64)} <= set(fused_embed.K4_TILES)
    assert fused_embed.k4_tile(None) == (128, 192)
    assert fused_embed.k4_tile([128, 64]) == (128, 64)
    assert fused_embed.wgmma_plan(3, 1024, 768, 64, 32) == \
        fused_embed.wgmma_plan(3, 1024, 768, 64, 32, (128, 192))
    for bad in ((64, 192), (128, 96), (128, 256)):
        with pytest.raises(ValueError, match="K4 tile"):
            fused_embed.wgmma_plan(3, 1024, 768, 64, 32, bad)
        with pytest.raises(ValueError, match="K4 tile"):
            fused_embed.check_wgmma_shape("stitch_embed", 3, 1024, 3072,
                                          768, 64, 32, 100, bad)
    from repro_torch.kernels.stitch import ops
    x = torch.zeros((1, 32, 32, 3))
    rec = torch.zeros((1, 1, 6), dtype=torch.int32)
    w = torch.zeros((3072, 64), dtype=torch.bfloat16)
    b = torch.zeros((64,), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K4 tile"):
        ops.stitch_embed(x, rec, w, b, 32, 32, 32, tile=(128, 96))
    assert ops.stitch_embed(x, rec, w, b, 32, 32, 32,
                            tile=(128, 64)).shape == (1, 1, 64)


@pytest.mark.parametrize("kdim,d,slot_elems,k,match", [
    (4 * 4 * 3, 16, 100, 4, "steps of 64"),
    (32 * 32 * 3, 12, 100, 4, "multiple of 8"),
    (32 * 32 * 3, 768, 2**31, 4, "int32"),
    (64 * 64 * 3, 768, 100, 2048, "shared memory"),
])
def test_check_wgmma_shape_rejects(kdim, d, slot_elems, k, match):
    patch = {48: 4, 3072: 32, 12288: 64}[kdim]
    with pytest.raises(ValueError, match=match):
        fused_embed.check_wgmma_shape("stitch_embed", 3, 1024, kdim, d, k,
                                      patch, slot_elems)


@pytest.mark.parametrize("k,patch", [(64, 32), (2048, 32), (64, 16),
                                     (64, 8)])
def test_check_wgmma_shape_accepts(k, patch):
    fused_embed.check_wgmma_shape("stitch_embed", 4, 1024, patch * patch * 3,
                                  768, k, patch, 402_653_184 // 4)


@pytest.mark.parametrize("k", [1, 64, 512, 2048])
@pytest.mark.parametrize("seq,d,patch", [(4096, 384, 16), (1024, 512, 32)])
def test_check_wgmma_shape_accepts_the_registry_detectors(seq, d, patch, k):
    """vit_s16 (patch 16: K = 768, d 384, 4,096 tokens a canvas) and
    efficientnet_b7 (patch 32, d 512) up to 2,048 records a canvas: d 384
    fills two column tiles of 192, d 512 two and a third of 128 columns;
    a 2,048-record block at patch 16 needs 164,920 bytes."""
    fused_embed.check_wgmma_shape("stitch_embed", 4, seq, patch * patch * 3,
                                  d, k, patch, 402_653_184 // 4)
    grid, smem = fused_embed.wgmma_plan(4, seq, d, k, patch)
    assert grid == ({384: 2, 512: 3}[d], seq // 128, 4)
    if (k, patch) == (2048, 16):
        assert smem == 164920


@pytest.mark.parametrize("p,side,want", [
    (73, 32, ((73, 4), True)),       # tangram: 32x32 cells a canvas
    (73, 64, ((73, 16), True)),      # vit_s16: 64x64 cells
    (1, 33, ((1, 5), False)),        # 1089 cells: scalar stores
    (4096, 64, ((4096, 16), True)),
])
def test_unstitch_decode_plan(p, side, want):
    """K3: one block per (slot, 256 cells), 16-byte stores when a slot's
    cells are a multiple of 4; every cell of every slot in one tile."""
    grid, vec = fused_embed.decode_plan(p, side, side)
    assert (grid, vec) == want
    assert (grid[1] - 1) * 256 < side * side <= grid[1] * 256
    with pytest.raises(ValueError, match="tiles of 256"):
        fused_embed.decode_plan(1, 4096, 4097)


@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 48, 64, 72, 80, 96, 104,
                               120, 128])
@pytest.mark.parametrize("b,sq,h", [(2, 4096, 24), (4, 197, 12), (1, 1, 3),
                                    (1, 4095, 24), (4, 4096, 16),
                                    (16, 1024, 16), (2, 64, 4), (3, 65, 6)])
def test_flash_attention_wgmma_plan(b, sq, h, d):
    """A block a (128 query rows, head, batch); shared memory Q and two
    stages of a K and a V tile of 128 rows of the head dim rounded up to
    16 (d itself at 32 / 64 / 128), in bf16, the barriers and 1024 bytes
    of alignment slack."""
    grid, smem = flash.wgmma_plan(b, sq, h, d)
    assert grid[1:] == (h, b)
    assert (grid[0] - 1) * 128 < sq <= grid[0] * 128
    dp = -(-d // 16) * 16
    q_tile = 128 * dp * 2
    kv_stage = 2 * 128 * dp * 2              # a K and a V tile
    assert smem == q_tile + 2 * kv_stage + 8 * 5 + 1024 <= SMEM_LIMIT


def test_flash_attention_heaviest_query_tile_first():
    """Block x takes query rows from (grid[0] - 1 - x) * 128: every tile
    once, the last (the heaviest when causal) first."""
    grid, _ = flash.wgmma_plan(2, 4096, 24, 128)
    starts = [(grid[0] - 1 - x) * flash.WG_ROWS for x in range(grid[0])]
    assert starts[0] == 4096 - 128
    assert sorted(starts) == list(range(0, 4096, 128))


def test_k6_takes_every_head_dim_the_configs_use():
    """K6 takes any multiple of 8 up to 128, as the Pallas kernel takes any
    D; bf16 runs the wgmma kernel at every one (the reduced configs' 16,
    DiT-XL/2's 72 padded to 80), float32 the FMA kernel.  K7 stays at
    32 / 64 / 128."""
    assert flash.HEAD_DIMS == tuple(range(8, 129, 8))
    assert flash.DECODE_HEAD_DIMS == (32, 64, 128)
    for d in (16, 32, 64, 72, 128):
        assert d in flash.HEAD_DIMS
    assert [flash.k6_kernel(torch.bfloat16, d) for d in (16, 32, 64, 72,
                                                         128)] == [
        "wgmma", "wgmma", "wgmma", "wgmma", "wgmma"]
    assert {flash.k6_kernel(torch.bfloat16, d)
            for d in flash.HEAD_DIMS} == {"wgmma"}
    assert {flash.k6_kernel(torch.float32, d)
            for d in flash.HEAD_DIMS} == {"fma"}
    assert [flash.padded_head_dim(d) for d in (8, 16, 24, 72, 120, 128)] == [
        16, 16, 32, 80, 128, 128]


def test_flash_attention_wgmma_plan_main_path_numbers():
    """DiT-XL/2 at gen_1024 (B=4, 4,096 tokens, 16 heads of 72 laid out at
    80): 32 x 16 x 4 blocks of Q plus two K / V stages, 5 x 128 rows of 160
    bytes (102,400 bytes) with 40 bytes of barriers and 1024 of slack; at
    gen_fast (B=16, 1,024 tokens) 8 x 16 x 16 blocks."""
    assert flash.wgmma_plan(4, 4096, 16, 72) == ((32, 16, 4), 103464)
    assert flash.wgmma_plan(16, 1024, 16, 72)[0] == (8, 16, 16)
    # the LM's D = 128 layout is what it was
    assert flash.wgmma_plan(2, 4096, 24, 128) == ((32, 24, 2), 164904)


def _k7_smem(d, dtype):
    """K7's block: 4 warps x 3 stages x (K and V tiles of 16 rows of D),
    the merged state (16 heads x D float32, then m and l), and for
    float32 q (16 x D) and a 16 x 16 score tile a warp."""
    elem = 2 if dtype == torch.bfloat16 else 4
    smem = 4 * 3 * 2 * 16 * d * elem + (16 * d + 32) * 4
    if dtype == torch.float32:
        smem += 16 * d * 4 + 4 * 16 * 16 * 4
    return smem


def _sized_to_pos(b, h, kvh, pos, sms):
    """(chunks, chunk) of a K7 grid sized to ``pos``, as the launch was
    planned before the kernel read ``pos`` from the device: as many chunks
    of whole 64-position block passes as give about one block an SM, at
    most 8, at most the passes of 0..pos."""
    groups = -(-(h // kvh) // 16)
    passes = -(-(pos + 1) // 64)
    n = max(1, min(8, sms // (b * kvh * groups), passes))
    chunk = -(-passes // n) * 64
    return pos // chunk + 1, chunk


def _chunks(pos, n_chunks):
    """The positions of each of K7's ``n_chunks`` chunks at ``pos``
    (``flash.decode_chunk``), and the chunk."""
    chunk = flash.decode_chunk(pos, n_chunks)
    return [range(c * chunk, min((c + 1) * chunk, pos + 1))
            for c in range(n_chunks)], chunk


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kvh,d,pos,sms", [
    (2, 24, 8, 128, 4095, 132),     # minitron-4b, B=2, the cache's end
    (2, 24, 8, 128, 287, 132),      # the decode run's last step
    (8, 24, 8, 128, 32767, 132),    # a decode_32k slice on one card
    (2, 24, 8, 128, 0, 132),        # the first step: one position
    (2, 24, 8, 128, 63, 132),       # one pass of the block
    (2, 24, 8, 128, 64, 132),
    (2, 24, 8, 128, 511, 132),
    (2, 24, 8, 128, 512, 132),
    (1, 8, 8, 32, 1000, 132),       # G = 1
    (3, 64, 8, 64, 2047, 132),      # G = 8
    (1, 48, 2, 128, 4095, 132),     # G = 24: two head groups
    (64, 24, 8, 128, 4095, 132),    # more pairs than SMs: one chunk
    (2, 24, 8, 128, 4095, 16),      # a small card
])
def test_flash_decode_plan(b, h, kvh, d, pos, sms, dtype):
    """The launch is fixed by Smax (a cache of pos + 1 and one of 32,768
    positions); at ``pos`` the chunks hold 0..pos exactly once, in
    multiples of 64, and the live ones are the chunks of a grid sized to
    ``pos``: the same work at every position."""
    for smax in (pos + 1, 32768):
        plan = flash.decode_plan(b, smax, h, kvh, d, dtype, sms)
        n_chunks = plan.grid[0]
        groups = -(-(h // kvh) // 16)
        assert plan.grid[1:] == (kvh * groups, b)
        assert plan.cluster == (n_chunks, 1, 1) and 1 <= n_chunks <= 8
        assert plan.grid[0] % plan.cluster[0] == 0
        chunks, chunk = _chunks(pos, n_chunks)
        assert chunk % 64 == 0
        assert [j for c in chunks for j in c] == list(range(pos + 1))
        live = pos // chunk + 1
        assert all(len(c) for c in chunks[:live])
        assert not any(len(c) for c in chunks[live:])
        assert (live, chunk) == _sized_to_pos(b, h, kvh, pos, sms)
        assert plan.stages == 3
        assert plan.smem == _k7_smem(d, dtype) <= SMEM_LIMIT
        # about one block an SM, unless the pairs alone fill the card; a
        # bf16 block leaves room for a second on its SM
        blocks = n_chunks * plan.grid[1] * b
        assert blocks <= sms or n_chunks == 1
        if dtype == torch.bfloat16:
            assert 2 * (plan.smem + 1024) <= 233472


@pytest.mark.parametrize("b,pos,want", [
    ((2, 4095, ((8, 8, 2), 512, 8))),
    ((2, 287, ((8, 8, 2), 64, 5))),
    ((8, 32767, ((2, 8, 8), 16384, 2))),
    ((2, 0, ((8, 8, 2), 64, 1))),
])
def test_flash_decode_plan_main_path_numbers(b, pos, want):
    """minitron-4b (24 / 8 heads x 128, bf16) on 132 SMs over a 32,768
    cache: 8 chunks a KV head at B=2 (128 blocks, 16 clusters of 8), 2 on
    the 8 x 32768 slice (128 blocks), whatever ``pos``; live, 8 of 512 at
    pos 4095, 5 of 64 at pos 287, 2 of 16,384 at pos 32,767 and one at pos
    0, as a grid sized to ``pos`` launched them."""
    plan = flash.decode_plan(b, 32768, 24, 8, 128, torch.bfloat16, 132)
    chunk = flash.decode_chunk(pos, plan.grid[0])
    assert (plan.grid, chunk, pos // chunk + 1) == want
    assert plan.smem == 98304 + 8320


def test_flash_decode_plan_rejects_pos_outside_the_cache():
    """A host pos outside [0, Smax) raises before anything is built; a
    tensor pos must be a 0-d int32 on the kernel's device (its value is
    the kernel's to clamp: checking it would sync the host)."""
    cuda = torch.device("cuda", 0)
    for pos in (4096, -1):
        with pytest.raises(ValueError, match="pos"):
            flash.decode_pos_arg(pos, 4096, cuda)
    assert flash.decode_pos_arg(4095, 4096, cuda) == (None, 4095)
    for bad in (torch.tensor(3), torch.tensor(3, dtype=torch.int32),
                torch.tensor([3], dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int32 tensor on cuda"):
            flash.decode_pos_arg(bad, 4096, cuda)
    cpu = torch.tensor(4096, dtype=torch.int32)
    assert flash.decode_pos_arg(cpu, 4096, cpu.device) == (cpu.data_ptr(), 0)
    with pytest.raises(ValueError, match="cache of 0"):
        flash.decode_plan(2, 0, 24, 8, 128, torch.bfloat16, 132)


@pytest.mark.parametrize("n_chunks", range(1, 9))
def test_decode_chunk_covers_every_position_once(n_chunks):
    """``decode_chunk`` (the kernel's, mirrored) at every pos up to 4,200:
    the chunks hold 0..pos once each, in whole 64-position passes, live
    chunks first, and as many live as a grid of at most ``n_chunks``
    sized to ``pos`` had."""
    for pos in range(4200):
        chunks, chunk = _chunks(pos, n_chunks)
        assert chunk % 64 == 0 and n_chunks * chunk > pos
        assert [j for c in chunks for j in c] == list(range(pos + 1))
        assert pos // chunk + 1 <= n_chunks
        # a grid sized to pos: min(n_chunks, passes) chunks of whole passes
        passes = pos // 64 + 1
        assert chunk == -(-passes // min(n_chunks, passes)) * 64


def test_flash_decode_cluster_never_exceeds_eight():
    """Over batch, KV heads, head groups, caches and SM counts the cluster
    of one (batch, KV head, group) stays within 1..8 and spans the grid's
    first axis."""
    for b in (1, 2, 3, 8, 64, 1024):
        for h, kvh in ((24, 8), (16, 16), (48, 2), (8, 1), (96, 8)):
            for smax in (1, 63, 64, 65, 512, 4096, 32768, 524288):
                for sms in (1, 16, 132, 264, 1000):
                    plan = flash.decode_plan(b, smax, h, kvh, 128,
                                             torch.bfloat16, sms)
                    assert 1 <= plan.cluster[0] <= 8
                    assert plan.cluster == (plan.grid[0], 1, 1)
                    assert plan.grid[0] <= -(-smax // 64)
