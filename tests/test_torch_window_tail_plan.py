"""The launch plans of the window tail kernels
(repro_torch/kernels/block_norm.py:block_norm_plan and
repro_torch/kernels/svm_matmul.py:svm_scores_plan), checked on the CPU
at B = 1, 11, 64 (the service's window_batch), 512 (the timing bench's
chunk) and 5,949 (one 640x480 frame's windows), and a numpy model of
svm_scores' summation order.

The CUDA kernels (csrc/block_norm.cu, csrc/svm_scores.cu) follow the
plans: block_norm's CTA (window b, band i) owns a band of block rows
across the window's full width and reads only the cell rows below them;
svm_scores' CTA owns 8 / SEGS rows, one warp a segment, in an order that
only the row width and dtype fix. Here the same rules run in Python over
the plain versions and the model, so a CTA that would read outside its
span, or an order that would depend on the batch, fails without a card.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import block_norm as bn
from repro_torch.kernels import build
from repro_torch.kernels import svm_matmul as sm
from repro_torch.kernels import tile_plan as tp

CH, CW = 16, 8                     # the paper window's cells
SIZES = (1, 11, 64, 512, 5949)
FLAVORS = ("rsqrt", "nr", "fixed")
F = 3780
DTYPES = (torch.float32, torch.bfloat16)
#: svm_scores against its plain version (chip_smoke.py SVM_ATOL,
#: MATMUL_ATOL): 3,780-term f32 sums in another order
ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
f32 = np.float32


def _hist(B, fixed, seed=0):
    rng = np.random.default_rng(seed)
    if fixed:
        return torch.from_numpy(rng.integers(0, 3000, (B, CH, CW, 9))
                                .astype(np.int16))
    return torch.from_numpy(rng.uniform(0, 40, (B, CH, CW, 9))
                            .astype(np.float32))


# ------------------------------------------------------- the compiled side

def test_block_norm_plan_matches_the_compiled_kernel():
    """The bands, bodies, width, launch arguments and refusals the wrapper
    relies on are the ones csrc/block_norm.cu is compiled with, over the
    tile body it shares with dense_block_norm."""
    src = (build.CSRC / "block_norm.cu").read_text()
    quads = [(int(r), int(t), 0) for r, t in re.findall(
        r"body == 0 && tr == \d+\) k = instance<Quads<(\d+), (\d+)>>", src)]
    whole = [(int(r), 128, 1) for r in re.findall(
        r"body == 1 && tr == \d+\) k = instance<OnePerBlock<(\d+)>>", src)]
    assert tuple(quads + whole) == bn.BLOCK_NORM_BANDS
    assert bn.SMALL_BANDS == tuple(quads) and bn.WHOLE_WINDOW == whole[0]
    for expr in (r"constexpr int CW = 8;", r"constexpr int PITCH = 12;",
                 r"using T = hog::Tile<TR, BW, TH>;",
                 r"THREADS = \(NBLK \+ 31\) / 32 \* 32;",
                 r"float cells\[\(TR \+ 1\) \* CW \* PITCH\];",
                 r"float out\[NBLK \* 36\];",
                 r'#include "block_tile.cuh"',
                 r"__launch_bounds__\(Body::THREADS\)",
                 r"hog::block_tile<NORM, In, T>\(",
                 # body 1: finish_block's arithmetic, squares in k order
                 r"ss = __fadd_rn\(ss, __fmul_rn\(x\[k\], x\[k\]\)\);",
                 r"hog::inv_norm<NORM>\(__fadd_rn\(ss, eps2\)\);",
                 r"o\[k\] = hog::quantize_value\(o\[k\], scale\);",
                 # the launcher's refusals: width, band, body and threads,
                 # shared memory, the bands' cover of the block rows
                 r"k == nullptr \|\| cw != CW \|\| smem_bytes < need \|\|",
                 r"bands \* tile_rows < ch - 1 \|\| \(bands - 1\) \* "
                 r"tile_rows >= ch - 1",
                 r"return th == want \? k : nullptr;"):
        assert re.search(expr, src), expr
    assert bn.WINDOW_CW == 8 and bn.CELL_PITCH == 12
    launch = re.search(r"int block_norm_launch\(([^)]*)\)", src)[1]
    assert len(launch.split(",")) == len(bn._ARGTYPES) == 13
    occ = re.search(r"int block_norm_occupancy\(([^)]*)\)", src)[1]
    assert len(occ.split(",")) == 6          # tile_plan.occupancy's six


def test_svm_plan_matches_the_compiled_kernel():
    src = (build.CSRC / "svm_scores.cu").read_text()
    for expr in (r"constexpr int THREADS = 256;", r"constexpr int ACC = 4;",
                 r"UNIT = 4, SEGS = 8;", r"UNIT = 8, SEGS = 4;",
                 r"constexpr int SEGS = D::SEGS, R = WARPS / SEGS;",
                 r"\*rows = WARPS / D::SEGS;",
                 r"\*smem = 4 \* \*rows \* \(D::SEGS \+ 1\);",
                 r"k == nullptr \|\| rows != want \|\| threads != THREADS \|\|",
                 r"static_cast<long long>\(grid\) \* rows < B \|\|"):
        assert re.search(expr, src), expr
    assert (sm.SVM_THREADS, sm.SVM_ACC) == (256, 4)
    assert sm.SVM_SEGS == {torch.float32: 8, torch.bfloat16: 4}
    launch = re.search(r"int svm_scores_launch\(([^)]*)\)", src)[1]
    assert len(launch.split(",")) == len(sm._ARGTYPES_SVM) == 12
    occ = re.search(r"int svm_scores_occupancy\(([^)]*)\)", src)[1]
    assert len(occ.split(",")) == 5          # tile_plan.occupancy's five


# ------------------------------------------------------- choice of plan

def test_plans_pick_per_batch():
    """block_norm: bands of 1 block row at B 1 and 11 (165 CTAs at 11), 3
    at B 64 (320), a whole window a CTA from one window a SM up;
    svm_scores: 1 (f32) or 2 (bf16) rows a CTA at every B."""
    got = [bn.block_norm_plan(B, CH, CW) for B in SIZES]
    assert [(p.rows, p.body) for p in got] == [(1, 0), (1, 0), (3, 0),
                                               (15, 1), (15, 1)]
    assert [p.ctas for p in got] == [15, 165, 320, 512, 5949]
    assert [p.threads for p in got] == [64, 64, 128, 128, 128]
    assert all(bn.block_norm_plan(B, CH, CW, f) == got[i]
               for i, B in enumerate(SIZES) for f in FLAVORS)
    for dt, rows in ((torch.float32, 1), (torch.bfloat16, 2)):
        got = [sm.svm_scores_plan(B, F, dt) for B in SIZES]
        assert {p.rows for p in got} == {rows}
        assert [p.ctas for p in got] == [-(-B // rows) for B in SIZES]


@pytest.mark.parametrize("B", SIZES)
def test_block_norm_plan_is_the_rule_over_the_compiled_bands(B):
    """From one window a SM up, a whole window a CTA; below, of the short
    bands the one that gives every SM a CTA and the fewest staged cell
    rows to the busiest SM, then the fewest CTAs, or the most CTAs where
    none fills the card."""
    for sms in (66, 114, 132):
        plan = bn.block_norm_plan(B, CH, CW, "rsqrt", sms)
        if B >= sms:
            assert (plan.rows, plan.threads, plan.body) == bn.WHOLE_WINDOW
            continue
        others = [bn.block_norm_plan_at(k, B, CH) for k in bn.SMALL_BANDS]
        assert plan in others and plan == tp.pick_band(others, sms)
        fit = [p for p in others if p.ctas >= sms]
        if fit:
            assert (plan.busiest_rows(sms), plan.ctas) == min(
                (p.busiest_rows(sms), p.ctas) for p in fit)
        else:
            assert plan.ctas == max(p.ctas for p in others)


@pytest.mark.parametrize("B", (11, 64, 512, 5949))
def test_block_norm_plans_give_every_sm_work(B):
    assert bn.block_norm_plan(B, CH, CW).ctas >= build.SMS
    for dt in DTYPES:
        plan = sm.svm_scores_plan(B, F, dt)
        assert plan.ctas >= build.SMS or B < plan.rows * build.SMS


# ------------------------------------------------------- coverage

@pytest.mark.parametrize("B", (1, 11, 64))
def test_block_bands_cover_every_block_once(B):
    """Every block row of every window is owned by exactly one CTA of
    every compiled band; each CTA stages the cell rows of its blocks and
    the one below, one contiguous span of the input, and writes one
    contiguous, 16-byte aligned span of the output."""
    for band in bn.BLOCK_NORM_BANDS:
        plan = bn.block_norm_plan_at(band, B, CH)
        assert plan.tile == band[::2]
        seen = np.zeros((B, CH - 1), np.int32)
        for b in range(B):
            for i in range(plan.bands):
                r0, r1 = plan.owned(i)
                assert r1 > r0                       # no CTA without work
                seen[b, r0:r1] += 1
                # staged: cells [r0, r1 + 1) x [0, 8), contiguous
                assert r1 + 1 <= CH
                # written: blocks [r0, r1) x [0, 7): 252 floats a row
                start = (b * (CH - 1) + r0) * (CW - 1) * 36
                assert (4 * start) % 16 == 0
                assert ((r1 - r0) * (CW - 1) * 36 * 4) % 16 == 0
        assert (seen == 1).all()
        assert plan.ctas == B * plan.bands


@pytest.mark.parametrize("B", (1, 11, 64, 513))
def test_svm_ctas_cover_every_row_and_segment_once(B):
    for dt in DTYPES:
        plan = sm.svm_scores_plan(B, F, dt)
        seen = np.zeros((B, plan.segs), np.int32)
        for i in range(plan.ctas):
            r0, r1 = plan.owned(i)
            assert r1 > r0
            for warp in range(sm.SVM_THREADS // 32):
                r, s = plan.segment_of(warp)
                if r0 + r < r1:
                    seen[r0 + r, s] += 1
        assert (seen == 1).all()


def test_svm_order_cuts_rows_into_whole_16_byte_units():
    for dt, unit, tail in ((torch.float32, 4, 0), (torch.bfloat16, 8, 4)):
        got_unit, segs, tail0 = sm.svm_order(F, dt)
        assert got_unit * dt.itemsize == 16 and got_unit == unit
        assert len(segs) == sm.SVM_SEGS[dt]
        assert F - tail0 == tail
        assert segs[0][0] == 0 and segs[-1][1] * unit == tail0
        assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
        # one chunk of 4 steps of 32 lanes a segment, about 1.9 KB
        assert max(u1 - u0 for u0, u1 in segs) <= 32 * sm.SVM_ACC
        assert all(1850 < (u1 - u0) * 16 < 1920 for u0, u1 in segs)
    # other widths: empty segments and a tail of every length
    for n in (1, 3, 9, 36, 37, 100):
        unit, segs, tail0 = sm.svm_order(n, torch.bfloat16)
        assert segs[-1][1] * unit == tail0 <= n < tail0 + unit


# ------------------------------------------------------- block_norm emulation

@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("band", bn.BLOCK_NORM_BANDS)
def test_block_bands_rebuild_the_batch_from_their_staged_cells(band, flavor):
    """Each CTA sees only its staged cell rows; the plain version run on
    those rows alone gives the band's blocks bit for bit, and the bands
    laid end to end the whole batch's."""
    hist = _hist(3, flavor == "fixed", seed=band[0])
    want = bn.block_norm_plain(hist, mode=flavor)
    plan = bn.block_norm_plan_at(band, 3, CH)
    got = torch.full_like(want, float("nan"))
    for b in range(3):
        for i in range(plan.bands):
            r0, r1 = plan.owned(i)
            got[b, r0:r1] = bn.block_norm_plain(hist[b:b + 1, r0:r1 + 1],
                                                mode=flavor)[0]
    assert torch.equal(got, want)


def test_block_norm_fixed_step_from_the_cells_max():
    """The tile body takes a block's int8 step as max|c| x (1/norm) (one
    multiply), the whole-window body as the max of the normalized values
    (finish_block): rounding is monotone, so both are the same f32 for
    every block."""
    rng = np.random.default_rng(7)
    c = rng.integers(0, 30000, (20000, 36)).astype(f32)
    rs = (f32(1) / np.sqrt((c * c).sum(1, dtype=f32) + f32(1))).astype(f32)
    v = c * rs[:, None]
    assert np.array_equal(np.abs(v).max(1), np.abs(c).max(1) * rs)


@pytest.mark.parametrize("band", bn.BLOCK_NORM_BANDS)
def test_block_norm_shared_memory_within_the_plan(band):
    plan = bn.block_norm_plan_at(band, 1, CH)
    rows, threads, body = band
    nblk = rows * (CW - 1)
    if body == 0:
        # the dense kernel's layout: squares, cells, 1/norm and step
        assert plan.smem_bytes == 4 * (36 * nblk + (rows + 1) * CW * 9
                                       + 2 * nblk)
        # whole warps, at most one a quad of outputs (else 4 outputs a
        # thread in turn)
        assert threads % 32 == 0 and threads <= -(-9 * nblk // 32) * 32
    else:
        # cells at a 12-float pitch (3 float4), then the staged blocks
        assert plan.smem_bytes == 4 * ((rows + 1) * CW * 12 + nblk * 36)
        assert threads == -(-nblk // 32) * 32      # one thread a block
        assert (4 * (rows + 1) * CW * 12) % 16 == 0 and (4 * 36) % 16 == 0
    assert plan.smem_bytes <= build.SMEM_DEFAULT


def test_block_norm_plans_refuse_other_windows():
    with pytest.raises(ValueError, match="8 across"):
        bn.block_norm_plan(4, 16, 9)
    with pytest.raises(ValueError, match="8 across"):
        bn.block_norm_plan(4, 1, 8)
    with pytest.raises(ValueError, match="norm flavor"):
        bn.block_norm_plan(4, 16, 8, "l1")
    assert bn.block_norm_plan(64, CH, CW, "fixed", 132) is \
        bn.block_norm_plan(64, CH, CW, "fixed", 132)


# ------------------------------------------------------- svm_scores model

def _segment_sums(x, w, segs, unit):
    """(B, segs) segment sums of csrc/svm_scores.cu:segment_sum in f32
    numpy: lane l takes units u0 + 32 j + l, adds their products one by
    one into accumulator j % 4; ((a0 + a1) + a2) + a3; a 5-step xor
    shuffle over the 32 lanes."""
    B = x.shape[0]
    lane = np.arange(32)
    out = np.zeros((B, len(segs)), f32)
    for s, (u0, u1) in enumerate(segs):
        acc = np.zeros((B, 32, sm.SVM_ACC), f32)
        for j in range(-(-(u1 - u0) // 32)):
            u = u0 + 32 * j + lane
            live = u < u1
            for t in range(unit):
                f = np.where(live, unit * u + t, 0)
                p = x[:, f] * w[f]
                a = acc[:, :, j % sm.SVM_ACC]
                acc[:, :, j % sm.SVM_ACC] = np.where(live, a + p, a)
        v = ((acc[..., 0] + acc[..., 1]) + acc[..., 2]) + acc[..., 3]
        for off in (16, 8, 4, 2, 1):
            v = v + v[:, lane ^ off]
        out[:, s] = v[:, 0]
    return out


def svm_model(x, w, bias, dtype, plan):
    """svm_scores as the kernel computes it under ``plan``: each warp's
    segment, the last warp's tail, then one thread a row adding its CTA's
    shared sums left to right."""
    B, n = x.shape
    unit, segs, tail0 = sm.svm_order(n, dtype)
    sums = _segment_sums(x, w, segs, unit)
    tail = np.zeros(B, f32)
    for f in range(tail0, n):
        tail = tail + x[:, f] * w[f]
    out = np.full(B, np.nan, f32)
    for i in range(plan.ctas):
        r0, r1 = plan.owned(i)
        part = np.full((plan.rows, plan.segs + 1), np.nan, f32)
        for warp in range(sm.SVM_THREADS // 32):
            r, s = plan.segment_of(warp)
            if r0 + r >= r1:
                continue
            part[r, s] = sums[r0 + r, s]
            if s == plan.segs - 1:
                part[r, plan.segs] = tail[r0 + r]
        for r in range(r1 - r0):
            acc = part[r, 0]
            for k in range(1, plan.segs + 1):
                acc = acc + part[r, k]
            out[r0 + r] = acc + bias
    return out


def _rows(B, dtype, seed=0):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.uniform(0, 0.4, (B, F)).astype(np.float32))
    return feats.to(dtype)


def _weights():
    g = np.load(build.CSRC.parents[2] / "tests" / "golden" / "hog_golden.npz")
    return g["svm_w"].astype(np.float32), f32(g["svm_b"])


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_svm_model_is_within_the_scorer_tolerance_of_the_plain_version(
        dtype):
    w, bias = _weights()
    feats = _rows(64, dtype, seed=1)
    x = feats.to(torch.float32).numpy()
    want = sm.svm_scores_plain(feats, torch.from_numpy(w),
                               torch.tensor(bias)).numpy()
    got = svm_model(x, w, bias, dtype, sm.svm_scores_plan(64, F, dtype))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype])
    assert np.abs(got - want).max() > 0       # another order than matmul


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_svm_model_row_scores_do_not_depend_on_batch_or_plan(dtype):
    """The same rows give the same bits at B 11 and 512, one row later in
    the batch (the other parity, where a bf16 row starts 8 bytes off a
    16-byte boundary), and in batches of 3."""
    w, bias = _weights()
    x = _rows(512, dtype, seed=2).to(torch.float32).numpy()
    base = svm_model(x, w, bias, dtype, sm.svm_scores_plan(512, F, dtype))
    small = svm_model(x[:11], w, bias, dtype, sm.svm_scores_plan(11, F,
                                                                  dtype))
    assert np.array_equal(small, base[:11])
    shifted = np.concatenate([x[5:6], x[:11]])
    got = svm_model(shifted, w, bias, dtype, sm.svm_scores_plan(12, F, dtype))
    assert np.array_equal(got[1:], base[:11])
    # and batch by batch, in batches of 3 rows (CTAs that straddle them)
    for r0 in range(0, 512, 3):
        rows = x[r0:r0 + 3]
        got = svm_model(rows, w, bias, dtype,
                        sm.svm_scores_plan(len(rows), F, dtype))
        assert np.array_equal(got, base[r0:r0 + 3])


def _shifted_units(words, u0, u1):
    """csrc/svm_scores.cu's kShift loads of one bf16 row that starts 8
    bytes off a 16-byte boundary, in numpy: ``words`` is the row as
    uint32 pairs of bf16 (the row's unit u is words[4u:4u + 4]); lane l
    of step j loads the aligned 16 bytes from the middle of unit u = u0 +
    32 j + l, takes unit u's first half from lane l - 1 (shfl_up), lane 0
    from lane 31 of the step before or, first, an 8-byte load. Returns
    the units the lanes see, in unit order."""
    got = {}
    carry = words[4 * u0: 4 * u0 + 2] if u0 < u1 else None     # the peel
    zero = np.zeros(4, words.dtype)
    for base in range(u0, u1, 32 * sm.SVM_ACC):
        xs = []
        for k in range(sm.SVM_ACC):
            lanes = []
            for lane in range(32):
                u = base + 32 * k + lane
                lanes.append(words[4 * u + 2: 4 * u + 6] if u < u1 else zero)
            xs.append(lanes)
        for k in range(sm.SVM_ACC):
            lanes = xs[k]
            nxt = lanes[31][2:4]
            for lane in range(32):
                u = base + 32 * k + lane
                lo = carry if lane == 0 else lanes[lane - 1][2:4]
                if u < u1:
                    got[u] = np.concatenate([lo, lanes[lane][:2]])
            carry = nxt
    return got


def test_shifted_bf16_loads_rebuild_every_unit():
    """An odd row at F = 3,780 (7,560 bytes: 8 off a 16-byte boundary):
    every segment's shifted loads and shuffles give each lane exactly the
    unit the aligned order assigns it, and no load reads past the row
    (its last 16 bytes end at the row's end, in the 4-feature tail)."""
    rng = np.random.default_rng(3)
    row = rng.integers(0, 2 ** 16, F, dtype=np.uint64).astype(np.uint16)
    words = row.view(np.uint32)              # F / 2 words; units of 4
    unit, segs, tail0 = sm.svm_order(F, torch.bfloat16)
    assert unit == 8 and F - tail0 >= 4      # the kShift condition
    for u0, u1 in segs:
        got = _shifted_units(words, u0, u1)
        assert sorted(got) == list(range(u0, u1))
        for u, v in got.items():
            assert np.array_equal(v, words[4 * u: 4 * u + 4]), u
        # the last load: bytes [16 u + 8, 16 u + 24) of the row
        assert 16 * (u1 - 1) + 24 <= 2 * F


def test_svm_plans_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no plan"):
        sm.svm_scores_plan(0, F, torch.float32)
    with pytest.raises(ValueError, match="no plan"):
        sm.svm_scores_plan(4, F, torch.float16)
    assert sm.svm_scores_plan(512, F, torch.bfloat16) is \
        sm.svm_scores_plan(512, F, torch.bfloat16)
    assert all(sm.svm_scores_plan(1, F, dt).smem_bytes <= build.SMEM_DEFAULT
               for dt in DTYPES)
