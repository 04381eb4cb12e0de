"""The launch plans of the torch port's convolution, attention, fused FF,
routing and absorbed-attention projection kernels, on the CPU.

`ff_plan` (fused FF) and `route_plan` (the routing stage of the fused FF
and the routing kernel) decide the warpgroups a block of the two GEMMs, the
row, column and expert tiles, and the depth splits of ff_down and of the
expert scores; they are held at the four SD1.5 FF shapes and at ragged ones
below.

`attn_plan` (self- and cross-attention) decides how many query rows a block
takes and how long a run of query tiles the cross kernel walks; it is held
at the eight SD1.5 attention shapes and at ragged ones below. `chain_plan`
(conv chain) and `fused_plan` (fused Winograd) decide, in plain
Python, how a launch is cut into blocks: the pixel rectangle, the output
channel tile and the share of the Cin depth each block takes, and whether the
depth is split over several blocks whose f32 partial sums a second kernel
adds in a fixed order. The kernels trust the plan, so it is held here, at
every SD1.5 shape `chip_smoke.py` runs and at the ragged shapes of
`tests/test_torch_cuda.py`: the blocks cover every output pixel, every output
channel and every input channel (with all 9 taps, or all 16 positions)
exactly once, a block's pixels lie in one image, and the plan is a function
of (B, H, W, Cin, Cout, SM count) alone.

`absorb_plan` (LN + q/k/v projection, out projection + residual) decides the
warpgroups and row panels of both kernels, kernel 5's runs of 160-column
tiles and weight ring, and kernel 6's depth split; it is held at the four
SD1.5 self-attention shapes and at the ragged ones of
`tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest

from diffusion_models_moe_tpu_torch.ops import attn_absorb_fused as ab
from diffusion_models_moe_tpu_torch.ops import conv_chain_fused as chain
from diffusion_models_moe_tpu_torch.ops import geglu_ff_fused as ffm
from diffusion_models_moe_tpu_torch.ops import routing_kernel as rk
from diffusion_models_moe_tpu_torch.ops import sd_flash
from diffusion_models_moe_tpu_torch.ops import winograd_fused as wino

H100_SMS = 132
# (B, H, W, Cin, Cout): the 14 resblock conv shapes of SD1.5 at UNet batch 4
CHAIN_SD15 = [(4, s, s, ci, co) for s, ci, co in (
    (64, 320, 320), (64, 640, 320), (64, 960, 320), (32, 320, 640),
    (32, 640, 640), (32, 960, 640), (32, 1280, 640), (32, 1920, 640),
    (16, 640, 1280), (16, 1280, 1280), (16, 1920, 1280), (16, 2560, 1280),
    (8, 1280, 1280), (8, 2560, 1280))]
# the same 14 convs at SD2.1-768's 96 x 96 latents (96, 48, 24, 12)
CHAIN_SD21 = [(b, 3 * h // 2, 3 * w // 2, ci, co)
              for b, h, w, ci, co in CHAIN_SD15]
CHAIN_RAGGED = [(3, 13, 9, 40, 72), (1, 7, 7, 8, 8), (2, 20, 12, 320, 136),
                (2, 8, 24, 96, 160), (1, 16, 16, 72, 168), (4, 8, 8, 1280, 8)]
# the 14 UNet (batch 4) and 8 VAE (batch 2) shapes of the fused Winograd mode
WINO_SD15 = [(4, s, s, ci, co) for s, ci, co in (
    (64, 320, 320), (64, 640, 320), (64, 960, 320), (64, 640, 640),
    (32, 320, 640), (32, 640, 640), (32, 960, 640), (32, 1280, 640),
    (32, 1920, 640), (32, 1280, 1280), (16, 640, 1280), (16, 1280, 1280),
    (16, 1920, 1280), (16, 2560, 1280))] + [(2, s, s, ci, co) for s, ci, co in (
        (64, 512, 512), (128, 512, 512), (256, 512, 512), (256, 512, 256),
        (256, 256, 256), (512, 256, 256), (512, 256, 128), (512, 128, 128))]
WINO_RAGGED = [(3, 18, 22, 24, 136), (1, 16, 16, 16, 128), (2, 20, 16, 72, 264),
               (1, 16, 48, 96, 128), (2, 16, 16, 1280, 136)]


def _covered_once(extent: int, step: int, count: int) -> bool:
    """`count` pieces of `step` from 0, clipped at `extent`, cover
    range(extent) exactly once and none is empty."""
    seen = np.zeros(extent, dtype=np.int64)
    for i in range(count):
        lo, hi = i * step, min((i + 1) * step, extent)
        if hi <= lo:
            return False
        seen[lo:hi] += 1
    return bool((seen == 1).all())


def _pixels_once(b, h, w, tiles_y, tiles_x, tile_h, tile_w) -> bool:
    """The kernels' decoding of grid y = image * tiles + tile: every pixel of
    every image in exactly one block, and a block in exactly one image."""
    seen = np.zeros((b, h, w), dtype=np.int64)
    tiles = tiles_y * tiles_x
    for by in range(b * tiles):
        image, tile = divmod(by, tiles)
        if image >= b:
            return False
        y0, x0 = (tile // tiles_x) * tile_h, (tile % tiles_x) * tile_w
        if y0 >= h or x0 >= w:
            return False            # a block with no pixel of its image
        seen[image, y0:y0 + tile_h, x0:x0 + tile_w] += 1
    return bool((seen == 1).all())


def _depth_once(cin, chunk, chunks, split, per) -> bool:
    """Splits of `per` chunks of `chunk` channels cover range(cin) once."""
    if chunks != -(-cin // chunk) or split < 1 or per < 1:
        return False
    seen = np.zeros(cin, dtype=np.int64)
    for s in range(split):
        n = min(per, chunks - s * per)      # the kernels' own count
        if n < 1:
            return False
        seen[s * per * chunk:min((s * per + n) * chunk, cin)] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("shape", CHAIN_SD15 + CHAIN_SD21 + CHAIN_RAGGED)
def test_chain_plan_covers_the_convolution_once(shape):
    b, h, w, cin, cout = shape
    plan = chain.chain_plan(*shape, H100_SMS)
    assert plan.tile_w in (8, 16)
    assert _pixels_once(b, h, w, plan.tiles_y, plan.tiles_x, chain.TILE_H,
                        plan.tile_w)
    assert _covered_once(cout, chain.COUT_TILE, plan.cout_tiles)
    assert _depth_once(cin, chain.CIN_CHUNK, plan.chunks, plan.split,
                       plan.chunks_per_split)


@pytest.mark.parametrize("shape", WINO_SD15 + WINO_RAGGED)
def test_fused_plan_covers_the_convolution_once(shape):
    b, h, w, cin, cout = shape
    assert wino.fused_ok(h, w, cin, cout)
    plan = wino.fused_plan(*shape, H100_SMS)
    assert _pixels_once(b, h, w, plan.blocks_y, plan.blocks_x, wino.SQUARE,
                        wino.SQUARE)
    assert _covered_once(cout, wino.COUT_TILE, plan.cout_tiles)
    assert _depth_once(cin, wino.CIN_CHUNK, plan.chunks, plan.split,
                       plan.chunks_per_split)


@pytest.mark.parametrize("sms", [1, 66, 108, 132, 1000])
@pytest.mark.parametrize("which", ["chain", "fused"])
def test_split_only_below_the_stated_blocks_per_sm(which, sms):
    """The depth is split only where the unsplit grid has at most
    SPLIT_BELOW_BLOCKS_PER_SM blocks an SM, the split grid stays within the
    resident blocks of the card (unless one split a chunk is all there is),
    and the same arguments give the same plan."""
    shapes = (CHAIN_SD15 + CHAIN_RAGGED if which == "chain"
              else WINO_SD15 + WINO_RAGGED)
    plan_of = chain.chain_plan if which == "chain" else wino.fused_plan
    n_split = 0
    for shape in shapes:
        plan = plan_of(*shape, sms)
        assert plan == plan_of(*shape, sms)
        unsplit = plan.blocks(shape[0]) // plan.split
        if unsplit > chain.SPLIT_BELOW_BLOCKS_PER_SM * sms:
            assert plan.split == 1 and plan.chunks_per_split == plan.chunks
            continue
        resident = 2 if which == "chain" and plan.tile_w == 8 else 1
        assert 1 <= plan.split <= plan.chunks
        assert plan.blocks(shape[0]) <= max(resident * sms, unsplit)
        n_split += plan.split > 1
    assert (n_split > 0) == (sms >= 66)


def test_plans_on_the_h100_split_the_small_levels():
    """What the rule gives at 132 SMs: the 8x8 and 16x16 levels of the UNet
    at batch 4 are split, 32x32 and 64x64 are not; a batch does not change
    which image a block belongs to, only how many blocks there are."""
    for shape in CHAIN_SD15:
        assert (chain.chain_plan(*shape, H100_SMS).split > 1) == (shape[1] <= 16)
    for shape in WINO_SD15:
        assert (wino.fused_plan(*shape, H100_SMS).split > 1) == (shape[1] <= 16)
    one = chain.chain_plan(1, 64, 64, 320, 320, H100_SMS)
    four = chain.chain_plan(4, 64, 64, 320, 320, H100_SMS)
    assert (one.tiles_y, one.tiles_x, one.tile_w) == (four.tiles_y, four.tiles_x,
                                                      four.tile_w)
    assert four.blocks(4) // four.split == 4 * (one.blocks(1) // one.split)


def test_chain_plans_on_the_h100_at_sd21():
    """At SD2.1-768's 96, 48, 24 and 12 side and UNet batch 4: no depth is
    split (even 12 x 12 gives 128 blocks of 8 x 8 pixels, near one an SM);
    16-pixel-wide tiles down to 24 x 24, whose last column of tiles is half
    empty, and 8 x 8 tiles at 12 x 12, whose last row and column hold 4."""
    got = [(s[1], s[3], p.tile_w, p.tiles_y, p.tiles_x, p.split, p.blocks(4))
           for s, p in ((sh, chain.chain_plan(*sh, H100_SMS))
                        for sh in CHAIN_SD21)]
    expect = {96: (16, 12, 6, 1, 576), 48: (16, 6, 3, 1, 288),
              24: (16, 3, 2, 1, 192), 12: (8, 2, 2, 1, 128)}
    for side, cin, *plan in got:
        assert tuple(plan) == expect[side], (side, cin)
    for _, h, w, cin, cout in CHAIN_SD21:
        assert chain.chain_ok(h, w, cin, cout)


def test_split_depth_keeps_every_split_non_empty():
    for chunks in range(1, 41):
        for blocks in (1, 7, 32, 40, 64, 66, 67, 500):
            split, per = chain.split_depth(blocks, chunks, H100_SMS, 1)
            assert (split - 1) * per < chunks <= split * per
            if blocks > 66:
                assert split == 1


# (kind, B, H, S_q, S_kv, D): the eight SD1.5 attention shapes at UNet batch 4
# and ragged ones (S no multiple of 64 or 128, few heads, D = 64)
ATTN_SD15 = [(kind, 4, 8, s, s if kind == "self" else 77, d)
             for kind in ("self", "cross")
             for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))]
# SD2.1-768 at UNet batch 4: 5, 10, 20 and 20 heads of 64 over 9216, 2304,
# 576 and 144 tokens
ATTN_SD21 = [(kind, 4, h, s, s if kind == "self" else 77, 64)
             for kind in ("self", "cross")
             for s, h in ((9216, 5), (2304, 10), (576, 20), (144, 20))]
ATTN_RAGGED = [(kind, b, h, s, s if kind == "self" else 77, d)
               for kind in ("self", "cross")
               for b, h, s, d in ((2, 3, 200, 40), (1, 2, 1000, 80),
                                  (4, 8, 4100, 40), (1, 1, 77, 64),
                                  (2, 3, 200, 160))]
# PixArt-512 at DiT batch 4: 16 heads of 72 over 1024 tokens, T5's 120
# keys; ragged: S no multiple of the tiles, key counts either side of 80
ATTN_PIXART = [("self", 4, 16, 1024, 1024, 72), ("cross", 4, 16, 1024, 120, 72)]
ATTN_PIXART_RAGGED = [("self", 2, 3, 1000, 1000, 72), ("self", 1, 2, 77, 77, 72),
                      ("cross", 2, 3, 1000, 100, 72), ("cross", 1, 2, 77, 81, 40),
                      ("cross", 2, 3, 200, 128, 64), ("cross", 2, 3, 200, 1, 80)]


@pytest.mark.parametrize("shape", ATTN_SD15 + ATTN_SD21 + ATTN_RAGGED
                         + ATTN_PIXART + ATTN_PIXART_RAGGED)
def test_attn_plan_covers_every_query_and_key_once(shape):
    """Blocks of `run` tiles of `rows` query rows cover every query row of a
    (batch, head) once, no block is empty by the kernel's own count, and the
    keys are covered once: in tiles of `bkv` (self) or in the one tile that
    holds all valid keys (cross: the smaller of 80 and 128 that does)."""
    kind, b, h, s_q, s_kv, d = shape
    plan = sd_flash.attn_plan(*shape, H100_SMS)
    assert plan.rows == sd_flash.Q_TILE * plan.wgs and plan.wgs in (1, 2)
    assert _covered_once(s_q, plan.rows * plan.run, plan.q_blocks)
    tiles = -(-s_q // plan.rows)
    for blk in range(plan.q_blocks):
        assert min(plan.run, tiles - blk * plan.run) >= 1
    if kind == "self":
        assert plan.run == 1 and plan.bkv == (64 if d > 80 else 128)
        assert _covered_once(s_kv, plan.bkv, -(-s_kv // plan.bkv))
        # the deepest K/V ring that fits the budget, and at least two stages
        assert 2 <= plan.stages <= sd_flash.MAX_STAGES
        smem = sd_flash.self_smem(d, plan.wgs, plan.bkv, plan.stages)
        assert smem <= sd_flash.SELF_SMEM_BUDGET
        assert (plan.stages == sd_flash.MAX_STAGES or sd_flash.self_smem(
            d, plan.wgs, plan.bkv, plan.stages + 1) > sd_flash.SELF_SMEM_BUDGET)
    else:
        assert plan.wgs == 1 and plan.bkv == (80 if s_kv <= 80 else 128)
        assert s_kv <= plan.bkv <= sd_flash.MAX_CROSS_KV
    assert plan.blocks(b, h) == b * h * plan.q_blocks


@pytest.mark.parametrize("sms", [1, 66, 132, 1000])
def test_attn_plan_fills_the_card_and_is_a_function_of_its_arguments(sms):
    """At every shape the grid has at least as many blocks as the card has
    SMs or as there are 64-row query tiles, whichever is fewer (S = 64 at
    batch 4 is 32 tiles in all); 128-row self blocks only where that grid
    still fills the card; the cross kernel's runs keep the grid within
    CROSS_BLOCKS_PER_SM blocks an SM unless every block has one tile; the
    same arguments give the same plan."""
    for shape in ATTN_SD15 + ATTN_RAGGED:
        kind, b, h, s_q, _, _ = shape
        plan = sd_flash.attn_plan(*shape, sms)
        assert plan == sd_flash.attn_plan(*shape, sms)
        tiles64 = b * h * -(-s_q // sd_flash.Q_TILE)
        assert plan.blocks(b, h) >= min(sms, tiles64)
        if kind == "self" and plan.wgs == 2:
            assert plan.blocks(b, h) >= sms
        if kind == "cross" and plan.run > 1:
            assert plan.blocks(b, h) <= sd_flash.CROSS_BLOCKS_PER_SM * sms + b * h


def test_attn_plans_on_the_h100():
    """What the rule gives at 132 SMs and UNet batch 4: 128-row self blocks
    at 64x64 and 32x32 latents, 64-row blocks at 16x16 and 8x8; the cross
    kernel's blocks walk 8, 2, 1, 1 query tiles."""
    got = [(k, s, p.wgs, p.run) for (k, _, _, s, _, _), p in
           ((sh, sd_flash.attn_plan(*sh, H100_SMS)) for sh in ATTN_SD15)]
    assert got == [("self", 4096, 2, 1), ("self", 1024, 2, 1),
                   ("self", 256, 1, 1), ("self", 64, 1, 1),
                   ("cross", 4096, 1, 8), ("cross", 1024, 1, 2),
                   ("cross", 256, 1, 1), ("cross", 64, 1, 1)]
    with pytest.raises(ValueError):
        sd_flash.attn_plan("self", 4, 8, 64, 64, 8, H100_SMS)


def test_attn_plans_on_the_h100_at_sd21():
    """At SD2.1-768's shapes every self-attention grid fills the card with
    128-row blocks (160 to 1440 blocks; at S = 144 the second block of a
    head holds 16 rows), keys in tiles of 128 through a six-stage ring at
    D = 64; the cross kernel's blocks walk 11, 6, 3 and 1 query tiles."""
    got = [(k, s, p.wgs, p.bkv, p.stages, p.run, p.blocks(b, h)) for
           (k, b, h, s, _, _), p in
           ((sh, sd_flash.attn_plan(*sh, H100_SMS)) for sh in ATTN_SD21)]
    assert got == [("self", 9216, 2, 128, 6, 1, 1440),
                   ("self", 2304, 2, 128, 6, 1, 720),
                   ("self", 576, 2, 128, 6, 1, 400),
                   ("self", 144, 2, 128, 6, 1, 160),
                   ("cross", 9216, 1, 80, 2, 11, 280),
                   ("cross", 2304, 1, 80, 2, 6, 240),
                   ("cross", 576, 1, 80, 2, 3, 240),
                   ("cross", 144, 1, 80, 2, 1, 240)]


def test_attn_plans_on_the_h100_at_pixart():
    """At PixArt-512's shapes (DiT batch 4, 16 heads of 72): 128-row self
    blocks (512 of them) on 128-key tiles through a four-stage ring, the
    deepest that SELF_SMEM_BUDGET holds at D = 72 (three 64-byte chunks a
    row); the cross kernel holds T5's 120 keys in its 128-key tile, its
    blocks walking 4 query tiles; SD's 77 keys keep the 80-key tile."""
    got = [(k, s, p.wgs, p.bkv, p.stages, p.run, p.blocks(b, h)) for
           (k, b, h, s, _, _), p in
           ((sh, sd_flash.attn_plan(*sh, H100_SMS)) for sh in ATTN_PIXART)]
    assert got == [("self", 1024, 2, 128, 4, 1, 512),
                   ("cross", 1024, 1, 128, 2, 4, 256)]
    assert sd_flash.self_smem(72, 2, 128, 4) <= sd_flash.SELF_SMEM_BUDGET
    assert sd_flash.self_smem(72, 2, 128, 5) > sd_flash.SELF_SMEM_BUDGET
    for keys, bkv in ((1, 80), (77, 80), (80, 80), (81, 128), (120, 128),
                      (128, 128)):
        assert sd_flash.attn_plan("cross", 4, 16, 1024, keys, 72,
                                  H100_SMS).bkv == bkv
    # D = 160 holds 80 keys at most; no plan past 128 keys
    assert sd_flash.attn_plan("cross", 4, 8, 256, 80, 160, H100_SMS).bkv == 80
    for keys, d in ((81, 160), (129, 72)):
        with pytest.raises(ValueError):
            sd_flash.attn_plan("cross", 4, 8, 256, keys, d, H100_SMS)


# (N, C, H, E) of the four SD1.5 FFs at UNet batch 4 (20-neuron experts) and
# ragged ones (N no multiple of any tile, E under a product, C no multiple
# of the 160-channel tile, H no multiple of the 128-column tile)
FF_SD15 = [(4 * t, c, 4 * c, 4 * c // 20)
           for t, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))]
# SD2.1-768's four FFs at UNet batch 4 (N = 4 x 9216, 2304, 576, 144)
FF_SD21 = [(4 * t, c, 4 * c, 4 * c // 20)
           for t, c in ((9216, 320), (2304, 640), (576, 1280), (144, 1280))]
FF_RAGGED = [(77, 64, 256, 12), (1000, 64, 256, 12), (4100, 320, 1280, 64),
             (3000, 96, 448, 100), (1, 32, 64, 1), (300, 1280, 5120, 256)]


@pytest.mark.parametrize("shape", FF_SD15 + FF_SD21 + FF_RAGGED)
def test_ff_plan_covers_every_tile_and_depth_chunk_once(shape):
    """Every launch of kernel 1 and its routing stage covers every row,
    column and depth chunk exactly once, with no empty part."""
    n, c, hdim, e = shape
    plan = ffm.ff_plan(n, c, hdim, e, H100_SMS)
    assert plan.up_wgs in (1, 2) and plan.down_wgs in (1, 2)
    assert _covered_once(n, ffm.WG_ROWS * plan.up_wgs, plan.up_row_tiles)
    assert _covered_once(hdim, ffm.UP_COLS, plan.up_col_tiles)
    assert plan.up_ctas == min(plan.up_tiles, H100_SMS)
    assert _covered_once(n, ffm.WG_ROWS * plan.down_wgs, plan.down_row_tiles)
    assert _covered_once(c, ffm.DOWN_COLS, plan.down_col_tiles)
    assert _depth_once(hdim, rk.DEPTH_CHUNK, plan.down_chunks, plan.down_split,
                       plan.down_chunks_per_split)
    r = plan.route
    assert r == rk.route_plan(n, hdim, e, H100_SMS)
    assert _covered_once(n, rk.ROWS, r.row_tiles)
    assert _covered_once(e, rk.EXPERT_TILE, r.e_tiles) and r.epad <= 256
    assert _depth_once(hdim, rk.DEPTH_CHUNK, r.chunks, r.split,
                       r.chunks_per_split)
    assert _covered_once(n, rk.MASK_ROWS, r.mask_row_tiles)
    assert _depth_once(hdim, rk.MASK_TILE, r.col_tiles, r.groups,
                       r.tiles_per_group)
    assert ffm.ff_plan(n, c, hdim, 0, H100_SMS).route is None


@pytest.mark.parametrize("sms", [1, 66, 132, 1000])
def test_ff_and_route_plans_split_only_where_the_rows_leave_sms_idle(sms):
    """A depth split (ff_down, the scores) only where the unsplit grid gives
    at most half the SMs a block, and then one that reaches the SMs as far as
    the depth allows (ff_down within one wave); the mask kernel's runs of
    column tiles as short as rounds of the blocks the SMs hold allow. The
    same arguments give the same plan, also after the cache is emptied."""
    for n, c, hdim, e in FF_SD15 + FF_RAGGED:
        plan = ffm.ff_plan(n, c, hdim, e, sms)
        ffm.ff_plan.cache_clear()
        rk.route_plan.cache_clear()
        assert plan == ffm.ff_plan(n, c, hdim, e, sms)
        unsplit = plan.down_row_tiles * plan.down_col_tiles
        if 2 * unsplit > sms:
            assert plan.down_split == 1
        else:
            # one block an SM: the split grid stays within one wave
            assert plan.down_split >= 2 or plan.down_chunks == 1
            assert plan.down_blocks <= sms
        r = plan.route
        if 2 * r.row_tiles > sms:
            assert r.split == 1
        else:
            assert r.score_blocks >= min(sms, r.row_tiles * r.chunks)
        # the mask: no other run a block gives fewer rounds x (tiles +
        # set-up)
        slots, setup = sms * rk.mask_blocks_per_sm(e), rk.MASK_BLOCK_COST
        cost = -(-r.mask_blocks // slots) * (r.tiles_per_group + setup)
        for per in range(1, r.col_tiles + 1):
            blocks = r.mask_row_tiles * -(-r.col_tiles // per)
            assert -(-blocks // slots) * (per + setup) >= cost


def test_ff_plans_on_the_h100_fill_the_card():
    """At the four SD1.5 FF shapes: ff_up's tiles and the scores' blocks
    give every SM of the H100 work (the scores' depth split wherever the
    64-row tiles are at most half the SMs); ff_down, whose block fills an
    SM's shared memory, and the mask pass run one round of blocks; ff_down's
    depth is split at the two small levels (N = 1024 and 256, H = 5120) and
    nowhere else."""
    for n, c, hdim, e in FF_SD15:
        plan = ffm.ff_plan(n, c, hdim, e, H100_SMS)
        assert plan.up_tiles >= H100_SMS and plan.up_ctas == H100_SMS
        # ff_down: one wave of 128 blocks of two warpgroups at the three
        # smaller levels (split at N = 1024 and 256), two at N = 16384
        assert plan.down_blocks == (256 if n == 16384 else 128)
        assert plan.route.score_blocks >= H100_SMS
        # the mask pass: one round of blocks, 80 of two column tiles at
        # N = 256 (its set-up is worth more than a second round of one-tile
        # blocks), 128 of 10 or 5 at N = 4096 and 1024, 256 of 10 (two an
        # SM) at N = 16384
        assert plan.route.mask_blocks == {16384: 256, 4096: 128, 1024: 128,
                                          256: 80}[n]
        assert plan.route.mask_blocks <= (
            H100_SMS * rk.mask_blocks_per_sm(e))
        assert (plan.down_split > 1) == (n <= 1024)
        assert (plan.route.split > 1) == (2 * n <= rk.ROWS * H100_SMS)
        assert plan.up_wgs == (1 if n == 256 else 2)


def test_ff_plans_on_the_h100_at_sd21():
    """At SD2.1-768's four FF shapes: ff_up persistent on all 132 SMs over
    2880 / 1440 / 720 / 200 tiles; ff_down unsplit at the three larger N
    (576, 288, 144 blocks) and split in 3 at N = 576 (120 blocks); the
    scores split in 4 and 16 at the two smaller N; the mask pass 1152, 360,
    126 and 100 blocks. Every FF shape is one the kernel takes."""
    got = [(n, p.up_tiles, p.up_ctas, p.up_wgs, p.down_blocks, p.down_split,
            p.route.score_blocks, p.route.split, p.route.mask_blocks)
           for (n, c, h, e), p in
           ((sh, ffm.ff_plan(*sh, H100_SMS)) for sh in FF_SD21)]
    assert got == [(36864, 2880, 132, 2, 576, 1, 576, 1, 1152),
                   (9216, 1440, 132, 2, 288, 1, 144, 1, 360),
                   (2304, 720, 132, 2, 144, 1, 144, 4, 126),
                   (576, 200, 132, 2, 120, 3, 144, 16, 100)]
    for n, c, h, e in FF_SD21:
        assert ffm.fused_ff_ok(n, c, h, e)
        assert rk.route_kernel_ok(h, e)


# (N, C) of the four SD1.5 self-attentions at UNet batch 4 and ragged ones
# (the GPU tests' N = 600, 77, 2000 at C = 320, 96, 1280; one row; a
# panel's worth plus one; the widest two-warpgroup C)
ABSORB_SD15 = [(4 * s, c) for s, c in ((4096, 320), (1024, 640), (256, 1280),
                                       (64, 1280))]
# SD2.1-768's four self-attentions at UNet batch 4: 5, 10, 20, 20 heads of 64
ABSORB_SD21 = [(4 * s, c) for s, c in ((9216, 320), (2304, 640), (576, 1280),
                                       (144, 1280))]
ABSORB_RAGGED = [(600, 320), (77, 96), (2000, 1280), (400, 320), (1, 8),
                 (65, 1280), (300, 448), (129, 512)]


@pytest.mark.parametrize("kind", ["qkv", "out"])
@pytest.mark.parametrize("shape", ABSORB_SD15 + ABSORB_SD21 + ABSORB_RAGGED)
def test_absorb_plan_covers_every_row_column_and_depth_chunk_once(shape,
                                                                  kind):
    """Every row, every output column (in each of q, k and v for kernel 5)
    and every 64-deep chunk of C is covered once, no run of column tiles or
    depth part is empty by the kernels' own counts, and kernel 5's block
    fits the shared memory of an SM with a ring of two stages or more."""
    n, c = shape
    plan = ab.absorb_plan(kind, n, c, H100_SMS)
    assert plan.kind == kind and plan.wgs in (1, 2)
    assert _covered_once(n, plan.rows, plan.row_tiles)
    per_weight = plan.col_tiles // 3 if kind == "qkv" else plan.col_tiles
    assert plan.col_tiles == per_weight * (3 if kind == "qkv" else 1)
    assert _covered_once(c, ab.QKV_COLS, per_weight)
    assert _covered_once(plan.col_tiles, plan.run, plan.groups)
    assert _depth_once(c, rk.DEPTH_CHUNK, plan.chunks, plan.split,
                       plan.chunks_per_split)
    if kind == "qkv":
        assert plan.split == 1
        assert 2 <= plan.stages <= ab.MAX_STAGES
        smem = ab.qkv_smem(plan.wgs, c, plan.stages, plan.boxes)
        assert smem <= ab.SMEM_BUDGET
        assert (plan.stages == ab.MAX_STAGES or ab.qkv_smem(
            plan.wgs, c, plan.stages + 1, plan.boxes) > ab.SMEM_BUDGET)
        # all five staging boxes unless they would leave fewer than three
        # stages
        assert plan.boxes == (ab.BOXES if ab.qkv_stages(plan.wgs, c) >= 3
                              else 1)
    else:
        assert plan.run == 1 and plan.stages == plan.boxes == 0


@pytest.mark.parametrize("sms", [1, 66, 132, 1000])
def test_absorb_plan_shares_out_only_where_the_rows_leave_sms_idle(sms):
    """Kernel 5 shares a panel's column tiles out over blocks, and kernel 6
    splits its depth, only where the unsplit grid gives at most half the SMs
    a block; then kernel 5 takes the shortest run whose blocks the SMs hold
    at once, and kernel 6 (the cut of ff_down) stays within one wave. Two
    warpgroups wherever there are more than 64 rows and (kernel 5) the
    panel leaves room for three stages. The same arguments give the same
    plan, also after the cache is emptied."""
    for n, c in ABSORB_SD15 + ABSORB_RAGGED:
        for kind in ("qkv", "out"):
            plan = ab.absorb_plan(kind, n, c, sms)
            ab.absorb_plan.cache_clear()
            assert plan == ab.absorb_plan(kind, n, c, sms)
            unsplit = plan.row_tiles * (1 if kind == "qkv" else plan.col_tiles)
            if 2 * unsplit > sms:
                assert plan.split == 1
                assert plan.run == (plan.col_tiles if kind == "qkv" else 1)
                continue
            if kind == "qkv":
                assert plan.blocks <= max(sms, plan.row_tiles)
                held = max(1, sms // plan.row_tiles)
                assert plan.run == 1 or -(-plan.col_tiles // (plan.run - 1)) > held
            else:
                assert plan.split >= 2 or plan.chunks == 1
                assert plan.blocks <= sms
        qkv = ab.absorb_plan("qkv", n, c, sms)
        assert (qkv.wgs == 2) == (n > ab.WG_ROWS and ab.qkv_stages(2, c) >= 3)
        assert ab.absorb_plan("out", n, c, sms).wgs == (2 if n > ab.WG_ROWS
                                                        else 1)


def test_absorb_plans_on_the_h100():
    """What the rules give at 132 SMs and UNet batch 4. Kernel 5: two
    warpgroups and all six column tiles a block at 64x64 latents (128
    blocks); one warpgroup and runs of 6, 3 and 1 tiles at C = 640 and
    1280 (128, 128 and 96 blocks), a ring of 4, 4, 3, 3 stages, the staging
    one box at a time at C = 1280. Kernel 6:
    256 and 128 blocks unsplit at the two large levels, the depth split in
    2 and 7 at the two small ones, as ff_down splits at the same N. The
    out projection's cut is ff_down's: the same rule over C's depth."""
    got = [(n, c, p.wgs, p.run, p.stages, p.boxes, p.blocks) for (n, c), p in
           ((sh, ab.absorb_plan("qkv", *sh, H100_SMS)) for sh in ABSORB_SD15)]
    assert got == [(16384, 320, 2, 6, 4, 5, 128), (4096, 640, 1, 6, 4, 5, 128),
                   (1024, 1280, 1, 3, 3, 1, 128), (256, 1280, 1, 1, 3, 1, 96)]
    got = [(n, c, p.wgs, p.split, p.chunks_per_split, p.blocks) for (n, c), p
           in ((sh, ab.absorb_plan("out", *sh, H100_SMS)) for sh in ABSORB_SD15)]
    assert got == [(16384, 320, 2, 1, 5, 256), (4096, 640, 2, 1, 10, 128),
                   (1024, 1280, 2, 2, 10, 128), (256, 1280, 2, 7, 3, 112)]
    for n, c in ABSORB_SD15:
        out = ab.absorb_plan("out", n, c, H100_SMS)
        ff = ffm.ff_plan(n, c, c, 0, H100_SMS)
        assert (out.wgs, out.row_tiles, out.col_tiles, out.chunks, out.split,
                out.chunks_per_split) == (
            ff.down_wgs, ff.down_row_tiles, ff.down_col_tiles, ff.down_chunks,
            ff.down_split, ff.down_chunks_per_split)
    with pytest.raises(ValueError):
        ab.absorb_plan("qkv", 256, 1472, H100_SMS)
    with pytest.raises(ValueError):
        ab.absorb_plan("proj", 256, 320, H100_SMS)


def test_absorb_plans_on_the_h100_at_sd21():
    """At SD2.1-768's shapes. Kernel 5: two warpgroups and all six column
    tiles a block at C = 320 (288 blocks); one warpgroup and runs of 12, 8
    and 2 tiles at C = 640 and 1280 (144, 108, 108 blocks), the staging one
    box at a time at C = 1280. Kernel 6: ff_down's cut at the same N,
    split in 3 at the smallest level only. Whole heads of 64 at every
    level."""
    got = [(n, c, p.wgs, p.run, p.stages, p.boxes, p.blocks) for (n, c), p in
           ((sh, ab.absorb_plan("qkv", *sh, H100_SMS)) for sh in ABSORB_SD21)]
    assert got == [(36864, 320, 2, 6, 4, 5, 288), (9216, 640, 1, 12, 4, 5, 144),
                   (2304, 1280, 1, 8, 3, 1, 108), (576, 1280, 1, 2, 3, 1, 108)]
    got = [(n, c, p.wgs, p.split, p.chunks_per_split, p.blocks) for (n, c), p
           in ((sh, ab.absorb_plan("out", *sh, H100_SMS)) for sh in ABSORB_SD21)]
    assert got == [(36864, 320, 2, 1, 5, 576), (9216, 640, 2, 1, 10, 288),
                   (2304, 1280, 2, 1, 20, 144), (576, 1280, 2, 3, 7, 120)]
    for n, c in ABSORB_SD21:
        assert ab.attn_absorb_ok(n // 4, c, c // 64)
