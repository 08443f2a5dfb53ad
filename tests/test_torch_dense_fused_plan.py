"""The launch plan of the dense fused HOG kernel
(repro_torch/kernels/fused_hog.py:dense_plan), checked on the CPU at the
shapes chip_smoke.py runs the kernel at -- every pyramid level of 640x480
and 1280x720, one frame and batches of 4 and 8 frames, and its ragged
shape -- and at the CPU tests' SCENES.

The CUDA kernel (csrc/dense_fused_hog.cu) follows the plan: CTA (tx, ty)
owns a tile of blocks (3x6, 3x4 or 2x4, chosen per level) and computes
the cells they need, those of its blocks' indices and the row below and
column to the right. Here the same rules run in Python over the plain
version's cell histograms, for every tile, so a block that would miss a
cell fails without a card.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import fused_hog as fh
from repro_torch.kernels.dense_grad_hist import dense_grad_hist_plain

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LEVELS = {f"{w}x{h}": [(1,) + s for s in chip_smoke.level_shapes(h, w)]
          for h, w in chip_smoke.FRAME_SIZES}
SHAPES = ([s for v in LEVELS.values() for s in v]
          + [chip_smoke.RAGGED, (1, 98, 130), (2, 59, 85)])
IDS = [f"{b}x{h}x{w}" for b, h, w in SHAPES]


def _ctas(plan):
    return [(tx, ty) for ty in range(plan.grid[1])
            for tx in range(plan.grid[0])]


def test_level_shapes_are_the_detectors():
    # 640x480: 59x79, 47x63 and 38x50 cells (PERF.md's CTA counts)
    assert LEVELS["640x480"] == [(1, 474, 634), (1, 378, 506),
                                 (1, 306, 402)]
    assert LEVELS["1280x720"] == [(1, 730, 1274), (1, 586, 1018),
                                  (1, 466, 818)]


def test_plan_matches_the_compiled_kernel():
    """The tiles, thread counts, gray pitch, launch bounds and launch
    arguments the wrapper passes are the ones csrc/dense_fused_hog.cu is
    compiled for."""
    src = (build.CSRC / "dense_fused_hog.cu").read_text()
    compiled = [tuple(map(int, m)) for m in re.findall(
        r"pick_mode<Tile<(\d+), (\d+)>>", src)]
    assert compiled == list(fh.DENSE_TILES)
    for expr in (r"THREADS = \(NSLOT \* 16 \+ 63\) / 64 \* 64;",
                 r"GP = \(SC \* 8 \+ 2\) \| 1;",
                 r"MIN_CTAS = THREADS <= 256 \? 5 : THREADS <= 320 \? 4 : 3;",
                 r"__launch_bounds__\(T::THREADS, T::MIN_CTAS\)"):
        assert re.search(expr, src), expr
    assert [fh.dense_threads(t) for t in fh.DENSE_TILES] == [448, 320, 256]
    assert [fh.dense_min_ctas(t) for t in fh.DENSE_TILES] == [3, 4, 5]
    assert [fh.dense_gray_pitch(t) for t in fh.DENSE_TILES] == [59, 43, 43]
    for tr, tc in fh.DENSE_TILES:
        # 16 threads a cell slot, one thread per 4 output values
        assert 16 * (tr + 1) * (tc + 1) <= fh.dense_threads((tr, tc))
        assert 9 * tr * tc <= fh.dense_threads((tr, tc))
    launch = re.search(r"int dense_fused_hog_launch\(([^)]*)\)", src)[1]
    assert len(launch.split(",")) == len(fh._DENSE_ARGTYPES) == 15


def test_plan_picks_a_tile_per_level():
    """At 640x480 the largest level takes 3x6-block tiles (260 CTAs, 2 on
    the busiest SM: 56 cells, against 4 x 20 with 3x4), the middle 3x4 and
    the smallest 2x4 (247 CTAs: 30 cells against 2 x 20); a level too
    small to give every SM a CTA takes the smallest tile."""
    got = [fh.dense_plan(*s).tile for s in LEVELS["640x480"]]
    assert got == [(3, 6), (3, 4), (2, 4)]
    assert [fh.dense_plan(*s).tile for s in LEVELS["1280x720"]] \
        == [(3, 6), (3, 6), (3, 4)]
    assert fh.dense_plan(*chip_smoke.RAGGED).tile == (2, 4)
    # another card: fewer SMs can take larger tiles
    assert fh.dense_plan(*LEVELS["640x480"][2], sms=100).tile == (3, 4)
    for shape in SHAPES:
        plan = fh.dense_plan(*shape)
        for t in fh.DENSE_TILES:
            other = fh._plan_for(t, *shape)
            if other.ctas >= fh.SMS:
                assert plan.ctas >= fh.SMS
                cells = [-(-p.ctas // fh.SMS) * (p.tile[0] + 1)
                         * (p.tile[1] + 1) for p in (plan, other)]
                assert cells[0] <= cells[1]


@pytest.mark.parametrize("tile", fh.DENSE_TILES, ids=lambda t: "%dx%d" % t)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plan_tiles_cover_every_block_once(shape, tile):
    plan = fh._plan_for(tile, *shape)
    bh, bw = plan.ch - 1, plan.cw - 1
    seen = np.zeros((bh, bw), np.int32)
    for tx, ty in _ctas(plan):
        r0, r1, c0, c1 = plan.blocks(tx, ty)
        seen[r0:r1, c0:c1] += 1
        # every CTA of the grid owns blocks (the launcher refuses others)
        assert r1 > r0 and c1 > c0
    assert (seen == 1).all()
    assert plan.grid[2] == shape[0]


@pytest.mark.parametrize("tile", fh.DENSE_TILES, ids=lambda t: "%dx%d" % t)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plan_stages_gray_inside_the_image(shape, tile):
    _, H, W = shape
    plan = fh._plan_for(tile, *shape)
    for tx, ty in _ctas(plan):
        r0, r1, c0, c1 = plan.cells(tx, ty)
        assert r1 > r0 and c1 > c0
        # gray rows 8 r0 .. 8 r1 + 1 and columns 8 c0 .. 8 c1 + 1
        assert 0 <= 8 * r0 and 8 * r1 + 1 < H
        assert 0 <= 8 * c0 and 8 * c1 + 1 < W
        # at most 4 gradient pixels a thread
        assert (r1 - r0) * (c1 - c0) * 64 <= 4 * plan.threads


@pytest.mark.parametrize("tile", fh.DENSE_TILES, ids=lambda t: "%dx%d" % t)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plan_reads_every_block_cell_from_a_cta_that_computed_it(
        shape, tile):
    """Each CTA keeps only the cells it computes; every cell of every
    block it owns is found there, at tile slot (r, c) from its first
    block, and equals the plain histogram."""
    B, H, W = shape
    gray = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (1, H, W)).astype(np.float32))
    hist = dense_grad_hist_plain(gray)[0].numpy()
    plan = fh._plan_for(tile, *shape)
    tr, tc = tile
    got = np.full((plan.ch - 1, plan.cw - 1, 2, 2, 9), np.nan, np.float32)
    for tx, ty in _ctas(plan):
        q0, q1, p0, p1 = plan.cells(tx, ty)
        own = hist[q0:q1, p0:p1]       # what its shared memory holds
        r0, r1, c0, c1 = plan.blocks(tx, ty)
        for bi in range(r0, r1):
            for bj in range(c0, c1):
                for i in (0, 1):
                    for j in (0, 1):
                        r, c = bi + i - ty * tr, bj + j - tx * tc
                        assert 0 <= r < own.shape[0], (tx, ty, r, c)
                        assert 0 <= c < own.shape[1], (tx, ty, r, c)
                        got[bi, bj, i, j] = own[r, c]
    want = np.stack([np.stack([hist[:-1, :-1], hist[:-1, 1:]], 2),
                     np.stack([hist[1:, :-1], hist[1:, 1:]], 2)], 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", fh.DENSE_TILES, ids=lambda t: "%dx%d" % t)
@pytest.mark.parametrize("mode", ["sector", "cordic", "fixed"])
def test_plan_shared_memory_within_the_default(mode, tile):
    plan = fh._plan_for(tile, 1, 474, 634, mode)
    assert plan.smem_bytes == fh.dense_smem_bytes(mode, tile)
    assert plan.smem_bytes % 4 == 0 and plan.threads == fh.dense_threads(tile)
    # a CTA needs no opt-in, and the CTAs the launch bounds promise fit an
    # H100 SM's 228 KB of shared memory (1 KB of it reserved per CTA)
    assert plan.smem_bytes <= build.SMEM_DEFAULT
    assert fh.dense_min_ctas(tile) * (plan.smem_bytes + 1024) <= 228 * 1024
    # the float modes keep 8 f32 row sums and an f32 histogram a cell,
    # the fixed mode one int32 sum and an int16 histogram
    assert fh.dense_smem_bytes("fixed", tile) < plan.smem_bytes or \
        mode == "fixed"


@pytest.mark.parametrize("level", range(3))
def test_plan_fills_the_card_at_640x480(level):
    plan = fh.dense_plan(*LEVELS["640x480"][level])
    assert plan.ctas >= fh.SMS
    if level == 0:
        # the CTAs an SM holds at least (the kernel's launch bounds)
        assert plan.resident_warps(fh.dense_min_ctas(plan.tile)) >= 16


@pytest.mark.parametrize("shape", SHAPES[:6], ids=IDS[:6])
def test_plan_recomputed_cells(shape):
    # a lone tile computes (TR+1) x (TC+1) cells for TR x TC blocks
    assert 1.5 <= fh.dense_plan(*shape).recompute() <= 1.85


def test_plan_refuses_a_scene_without_a_block():
    with pytest.raises(ValueError, match="block"):
        fh.dense_plan(1, 17, 66)


def test_plan_is_made_once_per_level_shape():
    # the wrapper asks for it at every launch, 3 times a frame
    shape = LEVELS["640x480"][0]
    assert fh.dense_plan(*shape, "fixed", 132) is \
        fh.dense_plan(*shape, "fixed", 132)
    assert fh.dense_plan(*shape, "fixed", 132) is not \
        fh.dense_plan(*shape, "sector", 132)


# ------------------------------------------------------- batches of frames

BATCHES = [(size, B) for size in LEVELS for B in (4, 8)]


@pytest.fixture
def one_thread():
    """The batched emulation runs in one thread: the suite runs files in
    parallel workers, and their thread pools would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("size,B", BATCHES,
                         ids=[f"{s}-B{b}" for s, b in BATCHES])
def test_plan_at_a_batch_rebuilds_each_frame_alone(size, B, one_thread):
    """At B 4 and 8 frames of each 640x480 and 1280x720 level: the plan
    keeps the rule at that B (every SM a CTA) and puts the batch on the
    grid's z axis; the CTAs of the first and the last frame rebuild, tile
    by tile -- each the cells of its own frame's staged gray, then its
    blocks from them alone -- that frame's blocks bit for bit as the plain
    version gives the frame alone (fixed mode)."""
    from repro_torch.kernels.dense_block_norm import dense_block_norm_plain
    ends = (0, B - 1)
    for _, H, W in LEVELS[size]:
        plan = fh.dense_plan(B, H, W, "fixed")
        assert plan.grid[2] == B and plan.ctas >= build.SMS
        assert plan.tile in fh.DENSE_TILES
        rng = np.random.default_rng(B + H)
        gray = torch.from_numpy(rng.integers(0, 256, (B, H, W))
                                .astype(np.float32))
        groups = {}
        for b in ends:
            for tx, ty in _ctas(plan):
                q0, q1, p0, p1 = plan.cells(tx, ty)
                groups.setdefault((q1 - q0, p1 - p0), []).append(
                    (b, q0, p0) + plan.blocks(tx, ty))
        got = torch.full((B, plan.ch - 1, plan.cw - 1, 36), float("nan"))
        for (nq, np_), items in groups.items():
            staged = torch.stack([gray[b, 8 * q0: 8 * (q0 + nq) + 2,
                                       8 * p0: 8 * (p0 + np_) + 2]
                                  for b, q0, p0, *_ in items])
            blocks = dense_block_norm_plain(
                dense_grad_hist_plain(staged, mode="fixed"), mode="fixed")
            for (b, q0, p0, r0, r1, c0, c1), blk in zip(items, blocks):
                assert (r0, c0) == (q0, p0)
                got[b, r0:r1, c0:c1] = blk[:r1 - r0, :c1 - c0]
        for b in ends:
            assert torch.equal(got[b], fh.dense_fused_hog_plain(
                gray[b:b + 1], mode="fixed")[0]), (H, b)
