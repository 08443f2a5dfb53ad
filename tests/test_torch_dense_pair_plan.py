"""The launch plans of the tiled dense pair
(repro_torch/kernels/dense_grad_hist.py:dense_grad_hist_plan and
repro_torch/kernels/dense_block_norm.py:dense_block_norm_plan), checked on
the CPU at the shapes chip_smoke.py runs the kernels at -- every pyramid
level of 640x480 and 1280x720, one frame and batches of 4 and 8 frames,
and its ragged shape -- and at small scenes.

The CUDA kernels (csrc/dense_grad_hist.cu, csrc/dense_block_norm.cu)
follow the plans: CTA (tx, ty) owns a disjoint tile of cells (blocks),
stages the gray of its cells with the 1-px halo (the cells of its blocks
and the row below and column to the right) and computes its tile from
that alone. Here the same rules run in Python over the plain versions,
tile by tile, so a CTA that would read outside what it stages fails
without a card.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import dense_block_norm as dbn
from repro_torch.kernels import dense_grad_hist as dgh
from repro_torch.kernels import tile_plan as tp

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LEVELS = {f"{w}x{h}": [(1,) + s for s in chip_smoke.level_shapes(h, w)]
          for h, w in chip_smoke.FRAME_SIZES}
SHAPES = ([s for v in LEVELS.values() for s in v]
          + [chip_smoke.RAGGED, (1, 98, 130), (2, 59, 85), (1, 18, 26)])
IDS = [f"{b}x{h}x{w}" for b, h, w in SHAPES]
# the small scenes the gray-to-histogram emulation runs at (a 640x480
# level through the plain version takes seconds)
SMALL = [chip_smoke.RAGGED, (1, 98, 130), (2, 59, 85), (1, 18, 26),
         (1, 122, 170)]
SMALL_IDS = [f"{b}x{h}x{w}" for b, h, w in SMALL]
MODES = ("sector", "cordic", "fixed")


def _ctas(plan):
    return [(tx, ty) for ty in range(plan.grid[1])
            for tx in range(plan.grid[0])]


def _hist_plan(tile, shape, mode="sector"):
    B, H, W = shape
    return tp.plan_at(tile, B, (H - 2) // 8, (W - 2) // 8,
                      dgh.grad_hist_threads(tile),
                      dgh.grad_hist_smem_bytes(mode, tile))


def _norm_plan(tile, shape):
    B, H, W = shape
    return tp.plan_at(tile, B, (H - 2) // 8 - 1, (W - 2) // 8 - 1,
                      dbn.block_norm_threads(tile),
                      dbn.block_norm_smem_bytes(tile))


def _gray(shape, fixed, seed=0):
    rng = np.random.default_rng(seed)
    g = (rng.integers(0, 256, shape) if fixed
         else rng.uniform(0, 255, shape))
    return torch.from_numpy(g.astype(np.float32))


# ------------------------------------------------------- the compiled side

def test_grad_hist_plan_matches_the_compiled_kernel():
    """The tiles, thread counts, gray pitch, launch bounds and launch
    arguments the wrapper passes are the ones csrc/dense_grad_hist.cu is
    compiled for."""
    src = (build.CSRC / "dense_grad_hist.cu").read_text()
    compiled = [tuple(map(int, m)) for m in re.findall(
        r"pick_mode<Tile<(\d+), (\d+)>>", src)]
    assert compiled == list(dgh.GRAD_HIST_TILES)
    for expr in (r"THREADS = NCELL \* 16;", r"NCELL = TR \* TC;",
                 r"GR = TR \* 8 \+ 2;", r"GC = TC \* 8 \+ 2;",
                 r"GP = GC \| 1;", r"MIN_CTAS = 1024 / THREADS;",
                 r"__launch_bounds__\(T::THREADS, T::MIN_CTAS\)"):
        assert re.search(expr, src), expr
    assert [dgh.grad_hist_threads(t) for t in dgh.GRAD_HIST_TILES] \
        == [128, 256]
    assert [dgh.grad_hist_gray_pitch(t) for t in dgh.GRAD_HIST_TILES] \
        == [35, 67]
    launch = re.search(r"int dense_grad_hist_launch\(([^)]*)\)", src)[1]
    assert len(launch.split(",")) == len(dgh._ARGTYPES) == 13
    occ = re.search(r"int dense_grad_hist_occupancy\(([^)]*)\)", src)[1]
    assert len(occ.split(",")) == 6          # tile_plan.occupancy's six


def test_block_norm_plan_matches_the_compiled_kernel():
    # the kernel, then the tile body it shares with the window kernel
    src = (build.CSRC / "dense_block_norm.cu").read_text() \
        + (build.CSRC / "block_tile.cuh").read_text()
    compiled = [tuple(map(int, m)) for m in re.findall(
        r"pick_norm<Tile<(\d+), (\d+)>>", src)]
    assert compiled == list(dbn.BLOCK_NORM_TILES)
    for expr in (r"int THREADS_ = \(TR_ \* TC_ \* 9 \+ 31\) / 32 \* 32>",
                 r"THREADS = THREADS_;",
                 r"NVAL = SR \* SC \* 9;", r"SR = TR \+ 1, SC = TC \+ 1;",
                 r"__launch_bounds__\(T::THREADS\)",
                 r'#include "block_tile.cuh"'):
        assert re.search(expr, src), expr
    assert [dbn.block_norm_threads(t) for t in dbn.BLOCK_NORM_TILES] == [160]
    launch = re.search(r"int dense_block_norm_launch\(([^)]*)\)", src)[1]
    assert len(launch.split(",")) == len(dbn._ARGTYPES) == 14
    occ = re.search(r"int dense_block_norm_occupancy\(([^)]*)\)", src)[1]
    assert len(occ.split(",")) == 6
    # the Smem layout the size formula counts: squares, cells, 1/norm and
    # the int8 step per block, all 4-byte
    assert re.search(r"float sq\[T::NBLK \* 36\];\s+// each block", src)
    assert re.search(r"float cells\[T::NVAL\];", src)
    assert re.search(r"float rs\[T::NBLK\];", src)
    assert re.search(r"float scale\[T::NBLK\];", src)


# ------------------------------------------------------- choice of tile

def test_plans_pick_a_tile_per_level():
    """At 640x480 dense_grad_hist takes 2x4-cell tiles at every level
    (600 / 384 / 247 CTAs: 40 / 24 / 16 cells on the busiest SM, against 48
    / 32 / 32 with 2x8); at 1280x720 2x8 where the busiest SM's cells tie
    (fewer CTAs), 2x4 at level 0.8. dense_block_norm has one tile."""
    got = [dgh.dense_grad_hist_plan(*s) for s in LEVELS["640x480"]]
    assert [p.tile for p in got] == [(2, 4)] * 3
    assert [p.ctas for p in got] == [600, 384, 247]
    assert [dgh.dense_grad_hist_plan(*s).tile for s in LEVELS["1280x720"]] \
        == [(2, 8), (2, 4), (2, 8)]
    assert dgh.dense_grad_hist_plan(*chip_smoke.RAGGED).tile == (2, 4)
    got = [dbn.dense_block_norm_plan(B, (H - 2) // 8, (W - 2) // 8)
           for B, H, W in LEVELS["640x480"]]
    assert [p.tile for p in got] == [(2, 8)] * 3
    assert [p.ctas for p in got] == [290, 184, 133]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_grad_hist_plan_is_the_rule_over_the_compiled_tiles(shape):
    """The pick gives every SM a CTA where any tile does, and no compiled
    tile that does puts fewer cells on the busiest SM; between equals, the
    fewest CTAs."""
    plan = dgh.dense_grad_hist_plan(*shape)
    for t in dgh.GRAD_HIST_TILES:
        other = _hist_plan(t, shape)
        if other.ctas >= build.SMS:
            assert plan.ctas >= build.SMS
            key = (plan.busiest_units(), plan.ctas)
            assert key <= (other.busiest_units(), other.ctas)
    if all(_hist_plan(t, shape).ctas < build.SMS
           for t in dgh.GRAD_HIST_TILES):
        assert plan.ctas == max(_hist_plan(t, shape).ctas
                                for t in dgh.GRAD_HIST_TILES)


def test_pick_plan_rule_on_made_up_plans():
    small = tp.plan_at((1, 1), 1, 10, 10, 32, 0)       # 100 CTAs
    big = tp.plan_at((2, 2), 1, 30, 30, 32, 0)         # 225 CTAs
    assert tp.pick_plan([small], sms=132) is small     # none fits: most
    assert tp.pick_plan([small, tp.plan_at((2, 2), 1, 10, 10, 32, 0)],
                        sms=132) is small
    assert big.busiest_units(132) == 2 * 4
    finer = tp.plan_at((1, 2), 1, 30, 30, 32, 0)       # 450 CTAs
    assert finer.busiest_units(132) == 4 * 2
    # a tie on the busiest SM's units goes to the fewer CTAs
    assert tp.pick_plan([finer, big], sms=132) is big
    assert tp.pick_plan([big, finer], sms=132) is big
    assert big.units(14, 14) == (28, 30, 28, 30)       # clipped
    assert big.resident_warps(4, 132) == pytest.approx(225 / 132)


@pytest.mark.parametrize("level", range(3))
def test_plans_fill_the_card_at_640x480(level):
    B, H, W = LEVELS["640x480"][level]
    for mode in MODES:
        plan = dgh.dense_grad_hist_plan(B, H, W, mode)
        assert plan.ctas >= build.SMS
        if level == 0:
            # the CTAs an SM holds at least (the launch bounds) cover the
            # grid's CTAs per SM: 4.5 CTAs of 4 warps
            assert plan.resident_warps(1024 // plan.threads) >= 16
    for mode in ("rsqrt", "nr", "fixed"):
        assert dbn.dense_block_norm_plan(B, (H - 2) // 8, (W - 2) // 8,
                                         mode).ctas >= build.SMS


# ------------------------------------------------------- coverage

@pytest.mark.parametrize("tile", dgh.GRAD_HIST_TILES,
                         ids=lambda t: "%dx%d" % t)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_grad_hist_tiles_cover_every_cell_once(shape, tile):
    B, H, W = shape
    plan = _hist_plan(tile, shape)
    seen = np.zeros((plan.rows, plan.cols), np.int32)
    for tx, ty in _ctas(plan):
        r0, r1, c0, c1 = plan.units(tx, ty)
        # every CTA of the grid owns cells (the launcher refuses others)
        assert r1 > r0 and c1 > c0
        seen[r0:r1, c0:c1] += 1
        # the staged gray, rows 8 r0 .. 8 r1 + 1 and columns 8 c0 ..
        # 8 c1 + 1, lies inside the image and inside the staging buffer
        assert 8 * r1 + 1 < H and 8 * c1 + 1 < W
        assert 8 * (r1 - r0) + 2 <= 8 * tile[0] + 2
        assert 8 * (c1 - c0) + 2 <= dgh.grad_hist_gray_pitch(tile)
        # at most 4 gradient pixels a thread, 16 threads a cell
        assert (r1 - r0) * (c1 - c0) * 64 <= 4 * plan.threads
    assert (seen == 1).all()
    assert plan.grid[2] == B


@pytest.mark.parametrize("tile", dbn.BLOCK_NORM_TILES,
                         ids=lambda t: "%dx%d" % t)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_block_norm_tiles_cover_every_block_once(shape, tile):
    B, H, W = shape
    ch, cw = (H - 2) // 8, (W - 2) // 8
    plan = _norm_plan(tile, shape)
    seen = np.zeros((ch - 1, cw - 1), np.int32)
    for tx, ty in _ctas(plan):
        r0, r1, c0, c1 = plan.units(tx, ty)
        assert r1 > r0 and c1 > c0
        seen[r0:r1, c0:c1] += 1
        # its staged cells [r0, r1 + 1) x [c0, c1 + 1) exist and fit the
        # (TR+1) x (TC+1) buffer
        assert r1 + 1 <= ch and c1 + 1 <= cw
        assert r1 - r0 <= tile[0] and c1 - c0 <= tile[1]
    assert (seen == 1).all()
    # one thread for each 4 of a tile's values
    assert 9 * tile[0] * tile[1] <= plan.threads


# ------------------------------------------------------- emulation

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tile", dgh.GRAD_HIST_TILES,
                         ids=lambda t: "%dx%d" % t)
@pytest.mark.parametrize("shape", SMALL, ids=SMALL_IDS)
def test_grad_hist_tiles_rebuild_the_histograms_from_their_staged_gray(
        shape, tile, mode):
    """Each CTA sees only its staged gray; the plain version run on that
    patch alone, tile by tile, gives the whole scene's histograms."""
    gray = _gray(shape, mode == "fixed")
    want = dgh.dense_grad_hist_plain(gray, mode=mode)
    plan = _hist_plan(tile, shape, mode)
    got = torch.zeros_like(want)
    for tx, ty in _ctas(plan):
        r0, r1, c0, c1 = plan.units(tx, ty)
        staged = gray[:, 8 * r0: 8 * r1 + 2, 8 * c0: 8 * c1 + 2]
        got[:, r0:r1, c0:c1] = dgh.dense_grad_hist_plain(staged, mode=mode)
    if mode == "fixed":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("mode", ("rsqrt", "nr", "fixed"))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_block_norm_tiles_rebuild_the_blocks_from_their_staged_cells(
        shape, mode):
    """Each block CTA sees only its staged cells; the plain version run on
    them alone, tile by tile, gives the whole scene's blocks bit for bit
    (a block depends on its own four cells only)."""
    B, H, W = shape
    ch, cw = (H - 2) // 8, (W - 2) // 8
    rng = np.random.default_rng(1)
    if mode == "fixed":
        hist = torch.from_numpy(rng.integers(0, 23105, (B, ch, cw, 9))
                                .astype(np.int16))
    else:
        hist = torch.from_numpy(rng.uniform(0, 3000, (B, ch, cw, 9))
                                .astype(np.float32))
    want = dbn.dense_block_norm_plain(hist, mode=mode)
    plan = dbn.dense_block_norm_plan(B, ch, cw, mode)
    got = torch.full_like(want, float("nan"))
    for tx, ty in _ctas(plan):
        r0, r1, c0, c1 = plan.units(tx, ty)
        staged = hist[:, r0: r1 + 1, c0: c1 + 1]
        got[:, r0:r1, c0:c1] = dbn.dense_block_norm_plain(staged, mode=mode)
    assert torch.equal(got, want)


# ------------------------------------------------------- resources

@pytest.mark.parametrize("tile", dgh.GRAD_HIST_TILES,
                         ids=lambda t: "%dx%d" % t)
@pytest.mark.parametrize("mode", MODES)
def test_grad_hist_shared_memory_within_the_default(mode, tile):
    plan = dgh.dense_grad_hist_plan(1, 474, 634, mode)
    size = dgh.grad_hist_smem_bytes(mode, tile)
    assert size % 4 == 0
    # the part sums (8 rows of 9 f32 a cell; fixed, 9 int32) then the gray
    part = -(-tile[0] * tile[1] * 9 * (1 if mode == "fixed" else 8) // 4) * 4
    assert size == 4 * (part + (8 * tile[0] + 2)
                        * dgh.grad_hist_gray_pitch(tile))
    # no opt-in, and the CTAs the launch bounds promise fit an H100 SM's
    # 228 KB of shared memory (1 KB of it reserved per CTA)
    assert size <= build.SMEM_DEFAULT
    assert (1024 // dgh.grad_hist_threads(tile)) * (size + 1024) \
        <= 228 * 1024
    assert plan.smem_bytes == dgh.grad_hist_smem_bytes(mode, plan.tile)


@pytest.mark.parametrize("tile", dbn.BLOCK_NORM_TILES,
                         ids=lambda t: "%dx%d" % t)
def test_block_norm_shared_memory_within_the_default(tile):
    tr, tc = tile
    size = dbn.block_norm_smem_bytes(tile)
    assert size == 4 * (36 * tr * tc + (tr + 1) * (tc + 1) * 9
                        + 2 * tr * tc)
    assert size <= build.SMEM_DEFAULT
    # sq, first, is whole 144-byte block rows: float4 reads stay aligned
    assert (36 * 4) % 16 == 0
    for mode in ("rsqrt", "fixed"):
        assert dbn.dense_block_norm_plan(1, 59, 79, mode).smem_bytes == size


# ------------------------------------------------------- edges

def test_plans_refuse_a_scene_without_a_cell_or_block():
    with pytest.raises(ValueError, match="cell"):
        dgh.dense_grad_hist_plan(1, 9, 66)
    with pytest.raises(ValueError, match="cell"):
        dgh.dense_grad_hist_plan(1, 66, 9)
    with pytest.raises(ValueError, match="block"):
        dbn.dense_block_norm_plan(1, 1, 8)
    with pytest.raises(ValueError, match="block"):
        dbn.dense_block_norm_plan(1, 8, 1)
    with pytest.raises(ValueError, match="norm flavor"):
        dbn.dense_block_norm_plan(1, 8, 8, "l1")


def test_plans_are_made_once_per_level_shape():
    # the wrappers ask for them at every launch, 3 times a frame each
    shape = LEVELS["640x480"][0]
    assert dgh.dense_grad_hist_plan(*shape, "fixed", 132) is \
        dgh.dense_grad_hist_plan(*shape, "fixed", 132)
    assert dgh.dense_grad_hist_plan(*shape, "fixed", 132) is not \
        dgh.dense_grad_hist_plan(*shape, "sector", 132)
    assert dbn.dense_block_norm_plan(1, 59, 79, "rsqrt", 132) is \
        dbn.dense_block_norm_plan(1, 59, 79, "rsqrt", 132)


def test_a_single_cell_scene_gets_one_cta():
    plan = dgh.dense_grad_hist_plan(1, 10, 10)
    assert plan.ctas == 1 and plan.units(0, 0) == (0, 1, 0, 1)
    plan = dbn.dense_block_norm_plan(1, 2, 2)
    assert plan.ctas == 1 and plan.units(0, 0) == (0, 1, 0, 1)


# ------------------------------------------------------- batches of frames

def _rebuild(frames, grid_xy, stage, own, src, fn, out_shape):
    """Every CTA (tx, ty, b) of a plan, b in ``frames`` (z slices of its
    grid): ``fn`` (a plain version) on the patch of frame b alone that it
    stages, its owned units of frame b taken from the result. Patches of
    one shape go through ``fn`` as one batch, each its own batch row."""
    groups = {}
    for b in frames:
        for tx, ty in grid_xy:
            s0, s1, t0, t1 = stage(tx, ty)
            groups.setdefault((s1 - s0, t1 - t0), []).append(
                (b, s0, t0) + own(tx, ty))
    out = None
    for (sh, sw), items in groups.items():
        res = fn(torch.stack([src[b, s0:s0 + sh, t0:t0 + sw]
                              for b, s0, t0, *_ in items]))
        if out is None:
            out = torch.full(out_shape + tuple(res.shape[3:]), -1,
                             dtype=res.dtype)
        for (b, _, _, r0, r1, c0, c1), r in zip(items, res):
            out[b, r0:r1, c0:c1] = r[:r1 - r0, :c1 - c0]
    return out


@pytest.fixture
def one_thread():
    """The batched emulations run in one thread: the suite runs files in
    parallel workers, and their thread pools would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BATCHES = [(size, B) for size in LEVELS for B in (4, 8)]
BATCH_IDS = [f"{size}-B{B}" for size, B in BATCHES]


@pytest.mark.parametrize("size,B", BATCHES, ids=BATCH_IDS)
def test_plans_at_a_batch_rebuild_each_frame_alone(size, B, one_thread):
    """At B 4 and 8 frames of each 640x480 and 1280x720 level: the plans
    follow the rule at that B and put the batch on the grid's z axis; the
    CTAs of the first and the last frame rebuild, tile by tile, each from
    its own frame's staged gray (cells) or cells (blocks), that frame's
    output bit for bit as the plain version gives the frame alone (fixed
    mode: exact integers; every norm flavor)."""
    ends = (0, B - 1)
    for _, H, W in LEVELS[size]:
        shape = (B, H, W)
        ch, cw = (H - 2) // 8, (W - 2) // 8
        gray = _gray(shape, True, seed=B + H)
        plan = dgh.dense_grad_hist_plan(B, H, W, "fixed")
        test_grad_hist_plan_is_the_rule_over_the_compiled_tiles(shape)
        assert plan.grid[2] == B
        hist = _rebuild(ends, _ctas(plan), lambda tx, ty: (
            lambda r0, r1, c0, c1: (8 * r0, 8 * r1 + 2, 8 * c0,
                                    8 * c1 + 2))(*plan.units(tx, ty)),
            plan.units, gray,
            lambda g: dgh.dense_grad_hist_plain(g, mode="fixed"),
            (B, ch, cw))
        for b in ends:
            assert torch.equal(hist[b], dgh.dense_grad_hist_plain(
                gray[b:b + 1], mode="fixed")[0]), b
        for mode in ("rsqrt", "nr", "fixed"):
            src = hist if mode == "fixed" else hist.to(torch.float32)
            nplan = dbn.dense_block_norm_plan(B, ch, cw, mode)
            assert nplan.grid[2] == B and nplan.ctas >= build.SMS
            blocks = _rebuild(ends, _ctas(nplan), lambda tx, ty: (
                lambda r0, r1, c0, c1: (r0, r1 + 1, c0, c1 + 1))(
                    *nplan.units(tx, ty)), nplan.units, src,
                lambda h: dbn.dense_block_norm_plain(h, mode=mode),
                (B, ch - 1, cw - 1))
            for b in ends:
                assert torch.equal(blocks[b], dbn.dense_block_norm_plain(
                    src[b:b + 1], mode=mode)[0]), (mode, b)
