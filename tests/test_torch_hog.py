"""The port's HOG stages (repro_torch.core) against the JAX reference
(repro.core), stage by stage, on the same numpy inputs.

Inputs come from numpy generators with fixed seeds and reach both
packages as the same arrays. Integer-valued gray (what a uint8 camera
gives) makes the gradients exact, so bins must match bit for bit there;
float-valued stages carry a stated tolerance.
"""
import importlib
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cordic as jcordic
from repro.core import hog as jhog
from repro.core import numerics as jnum
from repro.core import stages as jstages
from repro_torch.core import cordic as tcordic
from repro_torch.core import hog as thog
from repro_torch.core import numerics as tnum
from repro_torch.core.stages import dense_blocks
from repro_torch.kernels import mag_bin as tmb

# the module, not the same-named function repro.kernels re-exports
jhg = importlib.import_module("repro.kernels.hog_gradient")

GOLDEN = pathlib.Path(__file__).parent / "golden" / "hog_golden.npz"
CSRC = pathlib.Path(__file__).parents[1] / "src" / "repro_torch" / "csrc"


def _int_gray(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape) \
        .astype(np.float32)


def _grads(seed, shape=(3, 66, 98)):
    g = _int_gray(seed, shape)
    fx = g[..., 1:-1, 2:] - g[..., 1:-1, :-2]
    fy = g[..., 2:, 1:-1] - g[..., :-2, 1:-1]
    return fx, fy


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_grayscale_matches_reference():
    rgb = np.random.default_rng(0).integers(0, 256, (2, 40, 50, 3)) \
        .astype(np.uint8)
    want = np.asarray(jhog.grayscale(jnp.asarray(rgb)))
    got = thog.grayscale(_t(rgb)).numpy()
    # the same three f32 products and two adds in the same order
    np.testing.assert_array_equal(got, want)


def test_gradients_match_reference():
    g = np.random.default_rng(1).uniform(0, 255, (2, 20, 30)) \
        .astype(np.float32)
    for w, t in zip(jhog.gradients(jnp.asarray(g)), thog.gradients(_t(g))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["ref", "sector", "cordic", "fixed"])
def test_mag_bin_modes_match_on_integer_gray(mode):
    fx, fy = _grads(2)
    wm, wb = jhog._MAG_BIN[mode](jnp.asarray(fx), jnp.asarray(fy))
    tm, tb = thog._MAG_BIN[mode](_t(fx), _t(fy))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(wb))
    # sqrt of an exact integer sum and the integer CORDIC: identical; the
    # float CORDIC's magnitude differs by the reference's exp2(-13), one
    # ulp low on XLA's CPU backend
    rtol = 1e-6 if mode == "cordic" else 0
    np.testing.assert_allclose(tm.numpy(), np.asarray(wm), rtol=rtol, atol=0)


def test_mag_bin_ref_fast_is_sector_for_nine_bins():
    fx, fy = _grads(3)
    wm, wb = jhog.mag_bin_ref_fast(jnp.asarray(fx), jnp.asarray(fy))
    tm, tb = thog.mag_bin_ref_fast(_t(fx), _t(fy))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("mode", ["sector", "cordic"])
def test_kernel_mag_bin_twins_match_pallas_device_functions(mode):
    """kernels/mag_bin.py (the plain twin of csrc/mag_bin.cuh) against
    repro/kernels/hog_gradient.py's device functions, on integer gray and
    on float gradients that include the on-axis and zero cases."""
    fx, fy = _grads(4)
    rng = np.random.default_rng(5)
    ffx = rng.normal(0, 50, 4000).astype(np.float32)
    ffy = rng.normal(0, 50, 4000).astype(np.float32)
    ffx[:40], ffy[:40] = 0.0, rng.normal(0, 5, 40)       # on the y axis
    ffy[40:80] = 0.0                                      # on the x axis
    ffx[80:90], ffy[80:90] = 0.0, 0.0                     # zero gradient
    ffy[90:100] = -0.0
    for x, y in ((fx, fy), (ffx, ffy)):
        wm, wb = jhg.MAG_BIN_IMPLS[mode](jnp.asarray(x), jnp.asarray(y))
        tm, tb = tmb.MAG_BIN_IMPLS[mode](_t(x), _t(y))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(wb))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(wm))


def test_floor_mod_matches_jnp_mod():
    """torch.remainder is floor-mod like jnp.mod (hog.py:140), including
    the signed zeros and exact multiples of 180."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.uniform(-360, 360, 20000),
                        [180.0, -180.0, 0.0, -0.0, 360.0, -360.0,
                         -1e-7, 1e-7, 179.99999, -179.99999]]
                       ).astype(np.float32)
    want = np.asarray(jnp.mod(jnp.asarray(x), 180.0))
    got = torch.remainder(_t(x), 180.0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def test_sector_constants_in_cuda_header_are_f32_of_f64():
    """csrc/mag_bin.cuh carries each constant as the f32 rounding of the
    reference's f64 value (hog_gradient.py:32, cordic.py:33)."""
    src = (CSRC / "mag_bin.cuh").read_text()

    def array(name):
        body = re.search(name + r"\[\d+\]\s*=\s*\{(.*?)\};", src, re.S)
        return [np.float32(float(v.strip().rstrip("f")))
                for v in body.group(1).split(",")]

    bounds = [20.0 * (k + 1) for k in range(8)]
    assert array("kCosB") == [np.float32(math.cos(math.radians(b)))
                              for b in bounds]
    assert array("kSinB") == [np.float32(math.sin(math.radians(b)))
                              for b in bounds]
    lut = [np.float32(math.degrees(math.atan(2.0 ** -i))) for i in range(15)]
    assert array("kAtanLutDeg") == lut
    inv = re.search(r"kInvCordicGain\s*=\s*([0-9.e+-]+)f", src).group(1)
    gain = 1.0
    for i in range(15):
        gain *= math.sqrt(1.0 + 2.0 ** (-2 * i))
    assert np.float32(float(inv)) == np.float32(1.0 / gain)


@pytest.mark.parametrize("mode", ["sector", "cordic"])
def test_cell_histograms_match(mode):
    g = _int_gray(7, (2, 34, 50))
    cfg_j = jhog.HOGConfig(window_h=34, window_w=50, mode=mode)
    cfg_t = thog.HOGConfig(window_h=34, window_w=50, mode=mode)
    fx, fy = jhog.gradients(jnp.asarray(g))
    want = jhog.cell_histograms(*jhog._MAG_BIN[mode](fx, fy), cfg_j)
    got = thog.cell_histograms(*thog._MAG_BIN[mode](*thog.gradients(_t(g))),
                               cfg_t)
    # same bins; sums of 64 f32 magnitudes in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("norm", ["rsqrt", "nr"])
def test_block_normalize_matches(norm):
    hist = np.random.default_rng(8).uniform(0, 400, (2, 9, 7, 9)) \
        .astype(np.float32)
    hist[0, 0, 0] = 0.0                              # an empty cell
    cfg_j = jhog.HOGConfig(window_h=9 * 8 + 2, window_w=7 * 8 + 2)
    cfg_t = thog.HOGConfig(window_h=9 * 8 + 2, window_w=7 * 8 + 2)
    want = jhog.block_normalize(jnp.asarray(hist), cfg_j, norm=norm)
    got = thog.block_normalize(_t(hist), cfg_t, norm=norm)
    # unit-scale outputs; the 36-term sum of squares runs in another
    # order and lax.rsqrt is not torch.rsqrt, so a few ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_nr_rsqrt_matches_bitwise():
    x = np.random.default_rng(9).uniform(1e-4, 1e7, 5000).astype(np.float32)
    want = np.asarray(jnum.nr_rsqrt(jnp.asarray(x)))
    got = tnum.nr_rsqrt(_t(x)).numpy()
    # the same seed and the same sequence of f32 multiplies and subtracts
    np.testing.assert_array_equal(got, want)


def _assert_one_code_step(got, want):
    """The fixed chain's contract across backends
    (tests/test_fixed_point.py:221): at most one int8 code step per
    element, flips in under 1e-3 of the elements. The f32 sum of squares
    (values up to ~5e8 > 2^24) rounds by summation order, so a value on a
    rint boundary may take the neighbouring code."""
    step = np.abs(want).max(-1, keepdims=True) * np.float32(1 / 127)
    diff = np.abs(got - want)
    assert (diff <= step + 1e-6).all(), float(diff.max())
    assert (diff > 1e-6).mean() < 1e-3


def test_finish_blocks_fixed_matches_reference():
    """int16 histogram counts (half-gray units, up to the 23104 cell
    bound) through the NR rsqrt, eps * MAG_SCALE and the int8 grid."""
    rng = np.random.default_rng(10)
    v = rng.integers(0, 23105, (400, 36)).astype(np.int16)
    v[:100] //= 97                              # low-energy blocks
    v[0] = 0                                    # an empty block
    want = np.asarray(jnum.finish_blocks(jnp.asarray(v), 1e-2, "fixed"))
    got = tnum.finish_blocks(_t(v), 1e-2, "fixed").numpy()
    assert got.dtype == np.float32
    _assert_one_code_step(got, want)
    assert not got[0].any()


def test_fixed_block_normalize_is_on_the_int8_grid():
    hist = np.random.default_rng(11).integers(0, 3000, (2, 9, 7, 9)) \
        .astype(np.int16)
    cfg = thog.HOGConfig(window_h=9 * 8 + 2, window_w=7 * 8 + 2,
                         numerics="fixed")
    out = thog.block_normalize(_t(hist), cfg, norm="fixed").numpy()
    v = out.reshape(-1, 36)
    m = np.abs(v).max(-1, keepdims=True)
    codes = v * (127.0 / np.where(m > 0, m, 1.0))
    assert np.abs(codes - np.rint(codes)).max() < 1e-3
    jcfg = jhog.HOGConfig(window_h=9 * 8 + 2, window_w=7 * 8 + 2,
                          mode="cordic", numerics="fixed")
    want = np.asarray(jhog.block_normalize(jnp.asarray(hist), jcfg,
                                           norm="fixed"))
    _assert_one_code_step(out, want)


# ------------------------------------------------ fixed-point CORDIC

def _integer_sweep():
    """Every integer (fx, fy) in [-510, 510]^2: both axes, (0, 0), every
    20-degree edge an integer pair can reach, all four quadrants."""
    v = np.arange(-510, 511, dtype=np.float32)
    fx, fy = np.meshgrid(v, v)
    return fx.ravel(), fy.ravel()


def test_cordic_mag_bin_fixed_bit_identical_on_integer_sweep():
    fx, fy = _integer_sweep()
    wm, wb = jcordic.cordic_mag_bin_fixed(jnp.asarray(fx), jnp.asarray(fy))
    tm, tb = tcordic.cordic_mag_bin_fixed(_t(fx), _t(fy))
    assert tm.dtype == tb.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(wb))


def test_kernel_mag_bin_fixed_twin_matches_pallas_device_function():
    """kernels/mag_bin.py's fixed twin (the plain version of
    csrc/mag_bin.cuh:mag_bin_fixed) against _mag_bin_fixed."""
    fx, fy = _integer_sweep()
    wm, wb = jhg._mag_bin_fixed(jnp.asarray(fx), jnp.asarray(fy))
    tm, tb = tmb.MAG_BIN_IMPLS["fixed"](_t(fx), _t(fy))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(wb))
    assert tmb.MODE_CODES["fixed"] == 2


def test_fixed_cordic_constants_match_reference():
    assert tcordic.ANG_FRAC_BITS == jcordic.ANG_FRAC_BITS == 16
    assert tcordic.ANG_180 == jcordic.ANG_180 == 180 << 16
    assert tcordic.MAG_FRAC_BITS == jcordic.MAG_FRAC_BITS == 8
    assert tcordic.ATAN_LUT_FIXED == jcordic.ATAN_LUT_FIXED
    assert tcordic.ATAN_LUT_FIXED[0] == 45 << 16      # atan(1) exact
    assert np.float32(tcordic._INV_GAIN_HALF) == \
        np.float32(jcordic._INV_GAIN_HALF)


def test_int32_shift_and_floor_mod_semantics():
    """torch's >> on int32 is arithmetic like lax.shift_right_arithmetic,
    and torch.remainder / // on int32 floor like jnp.mod / jnp's //."""
    x = np.array([-2 ** 19, -1000, -257, -1, 0, 1, 255, 2 ** 19 - 1],
                 np.int32)
    for i in range(15):
        want = np.asarray(jax.lax.shift_right_arithmetic(
            jnp.asarray(x), jnp.int32(i)))
        np.testing.assert_array_equal((_t(x) >> i).numpy(), want)
    a = np.array([-3 * jcordic.ANG_180 + 5, -jcordic.ANG_180, -1, 0, 1,
                  jcordic.ANG_180, 2 * jcordic.ANG_180 - 1], np.int32)
    np.testing.assert_array_equal(
        torch.remainder(_t(a), tcordic.ANG_180).numpy(),
        np.asarray(jnp.mod(jnp.asarray(a), jcordic.ANG_180)))
    np.testing.assert_array_equal(
        (_t(a) // 1310720).numpy(),
        np.asarray(jnp.asarray(a) // 1310720))
    # round half to even: jnp.rint and torch.round
    h = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5, 127.5],
                 np.float32)
    np.testing.assert_array_equal(torch.round(_t(h)).numpy(),
                                  np.asarray(jnp.rint(jnp.asarray(h))))


def test_fixed_constants_in_cuda_headers():
    """csrc/mag_bin.cuh and csrc/finish_blocks.cuh carry the fixed chain's
    constants: the Q16 LUT, the f32 _INV_GAIN_HALF and 1/127."""
    src = (CSRC / "mag_bin.cuh").read_text()
    body = re.search(r"kAtanLutFixed\[15\]\s*=\s*\{(.*?)\};", src, re.S)
    assert tuple(int(v) for v in body.group(1).split(",")) == \
        jcordic.ATAN_LUT_FIXED
    for name, value in (("kAngFracBits", jcordic.ANG_FRAC_BITS),
                        ("kMagFracBits", jcordic.MAG_FRAC_BITS)):
        assert int(re.search(name + r"\s*=\s*(\d+);", src).group(1)) \
            == value
    inv = re.search(r"kInvGainHalf\s*=\s*([0-9.e+-]+)f", src).group(1)
    assert np.float32(float(inv)) == np.float32(jcordic._INV_GAIN_HALF)
    fin = (CSRC / "finish_blocks.cuh").read_text()
    invq = re.search(r"kInvQ\s*=\s*([0-9.e+-]+)f", fin).group(1)
    assert np.float32(float(invq)) == np.float32(1.0 / 127.0)


def test_fixed_cell_histograms_are_exact_int16():
    g = _int_gray(12, (2, 34, 50))
    cfg_j = jhog.HOGConfig(window_h=34, window_w=50, numerics="fixed")
    cfg_t = thog.HOGConfig(window_h=34, window_w=50, numerics="fixed")
    want = jhog.cell_histograms(
        *jhog.mag_bin_fixed(*jhog.gradients(jnp.asarray(g))), cfg_j)
    got = thog.cell_histograms(*thog.mag_bin_fixed(*thog.gradients(_t(g))),
                               cfg_t)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_specs_rows_match_reference():
    assert {k: tuple(vars(v).values()) for k, v in tnum.SPECS.items()} == \
        {k: tuple(vars(v).values()) for k, v in jnum.SPECS.items()}
    for mode in ("ref", "sector", "cordic"):
        assert tnum.spec_for(thog.HOGConfig(mode=mode)) == tnum.SPECS[mode]
    assert tnum.spec_for(thog.HOGConfig(numerics="fixed")).quantized


# ------------------------------------------------- golden descriptors

#: per-backend tolerance of tests/test_golden_reference.py:38
GOLDEN_TOL = {"ref": 2e-5, "kernel": 5e-5, "fused": 5e-5}


@pytest.mark.parametrize("backend", ["ref", "kernel", "fused"])
def test_dense_blocks_reproduce_golden_descriptors(backend):
    """The 130x66 golden windows through the port's dense_blocks: a
    130x66 scene's block grid is exactly the window's 15x7 descriptor.
    The golden reference bins with atan2, i.e. the "ref" mode."""
    golden = dict(np.load(GOLDEN))
    cfg = thog.HOGConfig(mode="ref" if backend == "ref" else "sector")
    got = dense_blocks(_t(golden["windows"]), cfg, backend)
    assert tuple(got.shape) == (3, 15, 7, 36)
    np.testing.assert_allclose(got.reshape(3, -1).numpy(),
                               golden["descriptors"], rtol=0,
                               atol=GOLDEN_TOL[backend])


@pytest.mark.parametrize("backend", ["ref", "kernel", "fused"])
def test_dense_blocks_fixed_match_reference(backend):
    """The whole fixed chain per backend, from float gray: the entry seam
    rounds it half to even, then integer CORDIC, int16 histograms and the
    int8 grid; held to the one-code-step contract."""
    g = np.random.default_rng(13).uniform(0, 255, (1, 114, 146)) \
        .astype(np.float32)
    g[0, :4, :4] = 100.5                      # on the rint boundary
    jcfg = jhog.HOGConfig(mode="cordic", numerics="fixed")
    want = np.asarray(jstages.dense_blocks(jnp.asarray(g), jcfg, backend))
    got = dense_blocks(_t(g), thog.HOGConfig(mode="cordic", numerics="fixed"),
                       backend).numpy()
    assert got.shape == want.shape == (1, 13, 17, 36)
    _assert_one_code_step(got, want)
