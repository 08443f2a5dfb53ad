"""The launch plans of the window kernels
(repro_torch/kernels/hog_gradient.py:hog_gradient_plan and
repro_torch/kernels/fused_hog.py:window_plan), checked on the CPU at the
batches chip_smoke.py runs the kernels at: B = 11, 64 (the service's
window_batch), 512 (the timing bench's chunk) and 5,949 (one 640x480
frame's windows).

The CUDA kernels (csrc/hog_gradient.cu, csrc/fused_hog.cu) follow the
plans: CTA (band i, window b) owns a band of output rows (block rows) of
window b, stages the band's gray rows -- one contiguous span -- by bulk
copies, one chunk per trip of its compute loop, and computes its outputs
from that alone. Here the same rules
run in Python over the plain versions, band by band, so a CTA that would
read outside what it stages fails without a card.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import fused_hog as fh
from repro_torch.kernels import hog_gradient as hg
from repro_torch.kernels import tile_plan as tp

H, W = 130, 66                     # the paper's window with the 1-px halo
SIZES = (11, 64, 512, 5949)
MODES = ("sector", "cordic", "fixed")


def _gray(B, fixed, seed=0):
    rng = np.random.default_rng(seed)
    g = (rng.integers(0, 256, (B, H, W)) if fixed
         else rng.uniform(0, 255, (B, H, W)))
    return torch.from_numpy(g.astype(np.float32))


def _plans(kernel, B):
    if kernel == "hog_gradient":
        return [hg.gradient_plan_at(r, B, H) for r in hg.GRADIENT_BANDS]
    return [fh.window_plan_at(k, B, H) for k in fh.WINDOW_BANDS]


# ------------------------------------------------------- the compiled side

def test_gradient_plan_matches_the_compiled_kernel():
    """The bands, thread counts, shared memory, launch bounds and launch
    arguments the wrapper passes are the ones csrc/hog_gradient.cu is
    compiled for."""
    src = (build.CSRC / "hog_gradient.cu").read_text()
    compiled = [int(m) for m in re.findall(r"pick_mode<Band<(\d+)>>", src)]
    assert compiled == list(hg.GRADIENT_BANDS)
    for expr in (r"THREADS = R \* 16 < 256 \? R \* 16 : 256;",
                 r"STAGED = TRIPS > 1;",
                 r"SMEM = STAGED \? hog::kBarBytes \+ 4 \* \(R \+ 2\) \* W "
                 r": 0;",
                 r"MIN_CTAS = 768 / THREADS;",
                 r"constexpr int W = 66;",
                 r"__launch_bounds__\(T::THREADS, T::MIN_CTAS\)"):
        assert re.search(expr, src), expr
    assert [hg.gradient_threads(r) for r in hg.GRADIENT_BANDS] \
        == [256, 256, 256, 256, 128]
    assert [hg.gradient_smem_bytes(r) for r in hg.GRADIENT_BANDS] \
        == [64 + 4 * (r + 2) * 66 for r in (128, 64, 32)] + [0, 0]
    assert [hg.gradient_staged(r) for r in hg.GRADIENT_BANDS] \
        == [True, True, True, False, False]
    stage = (build.CSRC / "window_stage.cuh").read_text()
    assert re.search(r"kMaxChunks = 8;", stage)
    assert re.search(r"kBarBytes = 8 \* kMaxChunks;", stage)
    assert hg.BAR_BYTES == 64
    launch = re.search(r"int hog_gradient_launch\(([^)]*)\)", src)[1]
    assert len(launch.split(",")) == len(hg._ARGTYPES) == 12
    occ = re.search(r"int hog_gradient_occupancy\(([^)]*)\)", src)[1]
    assert len(occ.split(",")) == 5          # tile_plan.occupancy's five


def test_window_plan_matches_the_compiled_kernel():
    src = (build.CSRC / "fused_hog.cu").read_text()
    compiled = [int(m) for m in re.findall(r"pick_mode<Band<(\d+)>>", src)]
    assert compiled == list(fh.WINDOW_BANDS)
    for expr in (r"constexpr int THREADS = 256;", r"constexpr int CP = 12;",
                 r"SR = K \+ 1;", r"GR = SR \* 8 \+ 2;",
                 r"NBLK = K \* BW;",
                 r"WPART = 2 \* 8 \* 9;",
                 r"SMEM = hog::kBarBytes\s+\+ 4 \* \(GR \* W \+ SR \* CW \* CP "
                 r"\+ THREADS / 32 \* WPART\);",
                 r"__launch_bounds__\(THREADS, 4\)"):
        assert re.search(expr, src), expr
    assert fh.WINDOW_THREADS == 256
    launch = re.search(r"int fused_hog_launch\(([^)]*)\)", src)[1]
    assert len(launch.split(",")) == len(fh._WINDOW_ARGTYPES) == 13
    occ = re.search(r"int fused_hog_occupancy\(([^)]*)\)", src)[1]
    assert len(occ.split(",")) == 5
    # 16 threads a cell, 16 cells a trip; one thread a block
    for k in fh.WINDOW_BANDS:
        assert 7 * k <= fh.WINDOW_THREADS


# ------------------------------------------------------- choice of band

def test_plans_pick_a_band_per_batch():
    """One band a window where the batch fills the card (B 512, 5,949):
    fewest CTAs among the plans that tie on the busiest SM's staged rows
    or beat them; smaller bands where it does not (B 64: 256 / 192 CTAs,
    B 11: 176 / 165)."""
    got = {B: hg.hog_gradient_plan(B, H, W) for B in SIZES}
    assert [got[B].band for B in SIZES] == [8, 32, 128, 128]
    assert [got[B].ctas for B in SIZES] == [176, 256, 512, 5949]
    got = {B: fh.window_plan(B, H, W) for B in SIZES}
    assert [got[B].band for B in SIZES] == [1, 5, 15, 15]
    assert [got[B].ctas for B in SIZES] == [165, 192, 512, 5949]
    assert all(fh.window_plan(B, H, W, m).band == got[B].band
               for B in SIZES for m in MODES)


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("kernel", ("hog_gradient", "fused_hog"))
def test_plan_is_the_rule_over_the_compiled_bands(kernel, B):
    """The pick gives every SM a CTA where any band does, and no compiled
    band that does puts fewer staged gray rows on the busiest SM; between
    equals, the fewest CTAs; where none does, the most CTAs."""
    plan = (hg.hog_gradient_plan(B, H, W) if kernel == "hog_gradient"
            else fh.window_plan(B, H, W))
    others = _plans(kernel, B)
    assert plan in others
    fit = [p for p in others if p.ctas >= build.SMS]
    if fit:
        assert plan.ctas >= build.SMS
        assert (plan.busiest_rows(), plan.ctas) == min(
            (p.busiest_rows(), p.ctas) for p in fit)
    else:
        assert plan.ctas == max(p.ctas for p in others)
    for sms in (66, 114, 132):           # the rule on other cards
        assert tp.pick_band(others, sms) in others


def test_pick_band_rule_on_made_up_plans():
    one = tp.BandPlan(100, 128, 1, 0, 128, 256, 0)      # 100 CTAs
    two = tp.BandPlan(100, 128, 1, 0, 64, 256, 0)       # 200 CTAs
    four = tp.BandPlan(100, 128, 1, 0, 32, 256, 0)      # 400 CTAs
    assert tp.pick_band([one], 132) is one              # none fits: most
    assert tp.pick_band([one, two, four], 132) is two   # 2 x 66 < 4 x 34
    assert two.busiest_rows(132) == 2 * 66
    assert four.busiest_rows(132) == 4 * 34
    assert tp.pick_band([four, two], 132) is two
    assert tp.pick_band([one, two], 64) is one          # 2 x 130 < 4 x 66
    assert one.resident_warps(4, 132) == pytest.approx(100 / 132 * 8)
    assert one.resident_warps(0, 132) == 0


def test_recompute_ratios():
    """hog_gradient's bands share no output row (each re-reads the 2 halo
    rows only); fused_hog's recompute one cell row per cut: 17/16 for two
    bands of a window, 30/16 for fifteen."""
    for r in hg.GRADIENT_BANDS:
        assert hg.gradient_plan_at(r, 1, H).recompute() == 1.0
    want = {15: 16, 8: 17, 5: 18, 3: 20, 1: 30}
    for k in fh.WINDOW_BANDS:
        assert fh.window_plan_at(k, 1, H).recompute() == want[k] / 16


@pytest.mark.parametrize("B", (64, 512, 5949))
def test_plans_fill_the_card(B):
    for mode in MODES:
        assert fh.window_plan(B, H, W, mode).ctas >= build.SMS
    assert hg.hog_gradient_plan(B, H, W).ctas >= build.SMS


# ------------------------------------------------------- coverage

@pytest.mark.parametrize("B", (1, 11))
@pytest.mark.parametrize("kernel", ("hog_gradient", "fused_hog"))
def test_bands_cover_every_unit_once(kernel, B):
    """Every output row (hog_gradient) or block row (fused_hog) of a
    window is owned by exactly one CTA of every compiled band, and each
    CTA's staged gray holds what it computes."""
    for plan in _plans(kernel, B):
        seen = np.zeros(plan.units, np.int32)
        for i in range(plan.bands):
            u0, u1 = plan.owned(i)
            assert u1 > u0                     # no CTA without work
            seen[u0:u1] += 1
            g0, g1 = plan.staged(i)
            assert 0 <= g0 < g1 <= H
            if kernel == "hog_gradient":
                # output row r reads gray rows r .. r + 2
                assert (g0, g1) == (u0, u1 + 2)
                assert (u1 - u0) * 16 <= plan.threads * (
                    plan.band * 16 // plan.threads)
            else:
                # block row j needs cell rows j, j + 1: gray 8j .. 8j + 17
                assert (g0, g1) == (8 * u0, 8 * (u1 + 1) + 2)
        assert (seen == 1).all()
        assert plan.ctas == B * plan.bands


@pytest.mark.parametrize("kernel", ("hog_gradient", "fused_hog"))
def test_staged_spans_are_16_byte_aligned(kernel):
    """A band's gray rows are one span of device memory that starts and
    ends on 16-byte boundaries (window b at b x 34,320 bytes), so one bulk
    copy (cp.async.bulk) or 16-byte copies can stage it."""
    assert (H * W * 4) % 16 == 0
    for plan in _plans(kernel, 3):
        for b in range(3):
            for i in range(plan.bands):
                g0, g1 = plan.staged(i)
                start = (b * H + g0) * W * 4
                assert start % 16 == 0 and ((g1 - g0) * W * 4) % 16 == 0


# ------------------------------------------------------- emulation

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("band", hg.GRADIENT_BANDS)
def test_gradient_bands_rebuild_the_batch_from_their_staged_gray(band, mode):
    """Each CTA sees only its staged gray rows; the plain version run on
    those rows alone, band by band, gives the whole batch's magnitudes and
    bins bit for bit (every pixel depends on its 3x3 neighbourhood
    only)."""
    gray = _gray(3, mode == "fixed", seed=band)
    want_m, want_b = hg.hog_gradient_plain(gray, mode)
    plan = hg.gradient_plan_at(band, 3, H)
    got_m = torch.full_like(want_m, -1)
    got_b = torch.full_like(want_b, -1)
    for b in range(3):
        for i in range(plan.bands):
            (u0, u1), (g0, g1) = plan.owned(i), plan.staged(i)
            m, k = hg.hog_gradient_plain(gray[b:b + 1, g0:g1], mode)
            got_m[b, u0:u1], got_b[b, u0:u1] = m[0], k[0]
    assert torch.equal(got_b, want_b)
    assert torch.equal(got_m, want_m)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("band", fh.WINDOW_BANDS)
def test_window_bands_rebuild_the_descriptors_from_their_staged_gray(band,
                                                                     mode):
    """Each CTA sees only its staged gray rows; the plain version run on
    them alone gives the band's blocks, and the bands, laid end to end in
    collate order, the whole batch's descriptors: fixed exactly, float
    within the blocks' 5e-5."""
    gray = _gray(2, mode == "fixed", seed=band)
    want = fh.fused_hog_plain(gray, mode=mode)
    plan = fh.window_plan_at(band, 2, H)
    got = torch.full_like(want, float("nan"))
    for b in range(2):
        for i in range(plan.bands):
            (u0, u1), (g0, g1) = plan.owned(i), plan.staged(i)
            part = fh.fused_hog_plain(gray[b:b + 1, g0:g1], mode=mode)
            assert part.shape == (1, (u1 - u0) * 7 * 36)
            got[b, u0 * 252: u1 * 252] = part[0]
    if mode == "fixed":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=5e-5)


def test_fused_hog_plain_is_dense_fused_hog_reshaped():
    """The identity the card holds the window kernel to, bit for bit, is
    already that of the two plain versions."""
    for mode in MODES:
        g = _gray(3, mode == "fixed", seed=9)
        assert torch.equal(fh.fused_hog_plain(g, mode=mode),
                           fh.dense_fused_hog_plain(g, mode=mode)
                           .reshape(3, -1))


# ------------------------------------------------------- resources

@pytest.mark.parametrize("band", hg.GRADIENT_BANDS)
def test_gradient_shared_memory_within_the_plan(band):
    plan = hg.gradient_plan_at(band, 1, H)
    for i in range(plan.bands):
        g0, g1 = plan.staged(i)
        # the mbarriers, then the staged rows (a band of one trip reads
        # device memory directly and takes none)
        if hg.gradient_staged(band):
            assert hg.BAR_BYTES + 4 * (g1 - g0) * W <= plan.smem_bytes
        else:
            assert plan.smem_bytes == 0 and (g1 - g0 - 2) * 16 \
                <= plan.threads
    assert plan.smem_bytes <= build.SMEM_DEFAULT
    # the CTAs the launch bounds promise fit an SM's 228 KB (1 KB each
    # reserved)
    assert (768 // plan.threads) * (plan.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("band", fh.WINDOW_BANDS)
def test_window_shared_memory_within_the_plan(band):
    plan = fh.window_plan_at(band, 1, H)
    cells = (band + 1) * 8 * 12                 # 9 bins padded to 3 float4
    parts = 8 * fh.WINDOW_PART                  # 8 warps' sums
    assert 2 * 7 * band <= parts                # then 1/norm and the step
    for i in range(plan.bands):
        g0, g1 = plan.staged(i)
        assert hg.BAR_BYTES + 4 * ((g1 - g0) * W + cells + parts) \
            <= plan.smem_bytes
    assert plan.smem_bytes == fh.window_smem_bytes(band)
    assert plan.smem_bytes <= build.SMEM_DEFAULT
    # the 4 CTAs the launch bounds promise fit an SM's 228 KB
    assert 4 * (plan.smem_bytes + 1024) <= 228 * 1024
    # the cells and the sums start 16-byte aligned (float4 reads, int4
    # zeroing)
    assert (hg.BAR_BYTES + 4 * (8 * (band + 1) + 2) * W) % 16 == 0
    assert (4 * cells) % 16 == 0 and (4 * fh.WINDOW_PART) % 16 == 0


@pytest.mark.parametrize("kernel", ("hog_gradient", "fused_hog"))
def test_staging_chunks_feed_each_trip(kernel):
    """window_stage.cuh's chunks: chunk i holds gray rows [0, step + 2)
    or [step i + 2, step (i + 1) + 2), clipped to the band, so trip i --
    gradient rows [step i, step (i + 1)) -- reads nothing past chunk i;
    every chunk is a 16-byte multiple at a 16-byte offset, and a band
    has at most 8 (kMaxChunks)."""
    for plan in _plans(kernel, 2):
        if kernel == "hog_gradient" and not hg.gradient_staged(plan.band):
            continue                     # reads device memory directly
        # gradient rows a trip: 16 output rows of 16 threads; two cell rows
        step = 16
        for i in range(plan.bands):
            g0, g1 = plan.staged(i)
            rows = g1 - g0
            n = (rows - 2 + step - 1) // step
            assert 1 <= n <= 8
            done = 0
            for c in range(n):
                lo = 0 if c == 0 else step * c + 2
                hi = min(step * (c + 1) + 2, rows)
                assert lo == done and hi > lo       # contiguous, in order
                assert (lo * W * 4) % 16 == 0 and ((hi - lo) * W * 4) % 16 == 0
                # trip c's last gradient row reads gray row + 2
                assert min(step * (c + 1), rows - 2) - 1 + 2 < hi
                done = hi
            assert done == rows


# ------------------------------------------------------- edges

def test_plans_are_made_once_per_batch_shape():
    # the wrappers ask for them at every launch
    assert hg.hog_gradient_plan(512, H, W, 132) is \
        hg.hog_gradient_plan(512, H, W, 132)
    assert fh.window_plan(64, H, W, "fixed", 132) is \
        fh.window_plan(64, H, W, "fixed", 132)
    assert fh.window_plan(64, H, W, "fixed", 132) is not \
        fh.window_plan(64, H, W, "sector", 132)


def test_plans_refuse_what_the_kernels_are_not_built_for():
    with pytest.raises(ValueError, match="66 columns"):
        hg.hog_gradient_plan(4, 130, 68)
    with pytest.raises(ValueError, match="66 columns"):
        hg.hog_gradient_plan(4, 131, 66)          # odd: spans unaligned
    with pytest.raises(ValueError, match="66 columns"):
        hg.hog_gradient_plan(4, 2, 66)            # no interior row
    with pytest.raises(ValueError, match="66 columns"):
        fh.window_plan(4, 130, 74)
    with pytest.raises(ValueError, match="at least 2"):
        fh.window_plan(4, 16, 66)                 # one cell row
    with pytest.raises(ValueError, match="mode"):
        fh.window_plan(4, 130, 66, "atan")


def test_layout_check_refuses_unaligned_and_other_windows():
    """What the wrappers check before a launch on the card, here on CPU
    tensors of the same layout."""
    base = torch.zeros(3 * H * W + 1)
    hg.check_window_layout(base[:3 * H * W].view(3, H, W), "k")
    with pytest.raises(ValueError, match="16-byte aligned"):
        hg.check_window_layout(base[1:].view(3, H, W), "k")
    with pytest.raises(ValueError, match="contiguous"):
        hg.check_window_layout(torch.zeros(3, W, H).transpose(1, 2), "k")
    with pytest.raises(ValueError, match="66 columns"):
        hg.check_window_layout(torch.zeros(3, H, 70), "k")
    with pytest.raises(ValueError, match="66 columns"):
        hg.check_window_layout(torch.zeros(3, 129, W), "k")


# ------------------------------------------------------- the sector count

def _sector_counts(fx, fy):
    """csrc/mag_bin.cuh in f32 numpy: mag_bin_sector's 8 tests
    fl(fl(uy*c) - fl(ux*s)) >= 0, and mag_bin4's reading of them (a
    compare of the two products, mirrored boundaries sharing them), with
    mag_bin4's guard (outside it a pixel goes back to mag_bin_sector)."""
    f32 = np.float32
    cos_b = np.cos(np.deg2rad(np.arange(20, 180, 20))).astype(f32)
    sin_b = np.sin(np.deg2rad(np.arange(20, 180, 20))).astype(f32)
    # the table's mirror symmetry the reading relies on, exactly
    assert (cos_b[::-1] == -cos_b).all() and (sin_b[::-1] == sin_b).all()
    flip = fy < 0
    ux = np.where(flip, -fx, fx)
    uy = np.where(flip, -fy, fy)
    ux = np.where((uy == 0) & (ux < 0), -ux, ux)
    with np.errstate(all="ignore"):
        a = uy[..., None] * cos_b
        c = ux[..., None] * sin_b
        want = ((a - c) >= 0).sum(-1)
        got = ((a[..., :4] >= c[..., :4]).sum(-1)
               + (-a[..., :4] >= c[..., :4]).sum(-1))
        # mag_bin4's guard: x = fx^2 + fy^2 is 0, or finite and at least
        # 2^-101 (sqrtf's fast range)
        x = fx * fx + fy * fy
    guard = (x == 0) | (np.isfinite(x) & (x >= f32(2.0 ** -101)))
    return want, got, guard


def test_sector_count_reading_is_mag_bin_sectors():
    """mag_bin4's sector count equals mag_bin_sector's wherever its guard
    lets it stand (everywhere but a tiny, infinite or NaN x): random
    gradients, gradients a few ulps off each 20-degree boundary, zeros of
    both signs, denormals and large values."""
    f32 = np.float32
    rng = np.random.default_rng(11)
    fx = rng.uniform(-255, 255, 200_000).astype(f32)
    fy = rng.uniform(-255, 255, 200_000).astype(f32)
    # on and next to the boundaries, at several radii
    ang = np.deg2rad(np.repeat(np.arange(0, 361, 20), 400)
                     + rng.integers(-3, 4, 19 * 400) * 1e-6)
    r = np.repeat(rng.uniform(1e-3, 400, 19 * 400), 1)
    bx = (r * np.cos(ang)).astype(f32)
    by = (r * np.sin(ang)).astype(f32)
    edge = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-38, 3e-39, 1.0,
                     -1.0, 255.0, -255.0, 1e30, -1e30, 3e38, -3e38],
                    f32)
    ex, ey = (a.ravel() for a in np.meshgrid(edge, edge))
    for x, y in ((fx, fy), (bx, by), (np.nextafter(bx, f32(np.inf)), by),
                 (bx, np.nextafter(by, f32(-np.inf))), (ex, ey)):
        want, got, guard = _sector_counts(x, y)
        assert (got[guard] == want[guard]).all()
        if x is not ex:
            assert guard.all()          # no real gradient is sent back
