"""Each kernel's plain PyTorch version (repro_torch.kernels.*) against the
JAX Pallas kernel it replaces, run as the JAX package's own tests run it
on the CPU (interpret mode), in every mode and on ragged slab shapes. The
CUDA kernels themselves run only on the card: chip_smoke.py holds each
against these plain versions there.

Tolerances (absolute unless stated), each set by summation order only:
float histograms rtol 1e-5, float blocks 5e-5, score_matmul f32 1e-5 and
bf16 1e-4. The fixed chain's integer stages are exact (int16
histograms, int32 scores); its blocks may differ by one int8 code step
in under 1e-3 of the elements (the reference's own contract between its
backends, tests/test_fixed_point.py:221), since the f32 sum of squares
before the quantizer rounds by summation order.

The window kernels (hog_gradient, cell_hist, block_norm, fused_hog,
svm_scores) run on B = 11 seeded 130x66 windows, a ragged last tile
against the reference's 8-window slabs: bins and integer stages exact,
float magnitudes exact on integer gray and within 1e-6 relative on
float gray (the jitted reference contracts fx*fx + fy*fy into an FMA),
svm_scores 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_norm import block_norm as j_win_block_norm
from repro.kernels.cell_hist import cell_hist as j_cell_hist
from repro.kernels.dense_block_norm import dense_block_norm as j_block_norm
from repro.kernels.dense_grad_hist import dense_grad_hist as j_grad_hist
from repro.kernels.fused_hog import dense_fused_hog as j_fused
from repro.kernels.fused_hog import fused_hog as j_win_fused
from repro.kernels.hog_gradient import hog_gradient as j_hog_gradient
from repro.kernels.svm_matmul import score_matmul as j_score_matmul
from repro.kernels.svm_matmul import score_matmul_int8 as j_score_int8
from repro.kernels.svm_matmul import svm_scores as j_svm_scores
from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.block_norm import block_norm, block_norm_plain
from repro_torch.kernels.cell_hist import cell_hist, cell_hist_plain
from repro_torch.kernels.fused_hog import fused_hog, fused_hog_plain
from repro_torch.kernels.hog_gradient import (hog_gradient,
                                              hog_gradient_plain)
from repro_torch.kernels.svm_matmul import svm_scores, svm_scores_plain
from repro_torch.kernels.dense_block_norm import (dense_block_norm,
                                                  dense_block_norm_plain)
from repro_torch.kernels.dense_grad_hist import (dense_grad_hist,
                                                 dense_grad_hist_plain)
from repro_torch.kernels.fused_hog import dense_fused_hog, dense_fused_hog_plain
from repro_torch.kernels.svm_matmul import (score_matmul, score_matmul_int8,
                                            score_matmul_int8_plain,
                                            score_matmul_plain)
from test_torch_hog import _assert_one_code_step

# (B, H, W) gray scenes: 12 cell rows against the reference's 8-row
# slabs, and 7 against 8 (one short slab) with an untrimmed width
SCENES = [(1, 98, 130), (2, 59, 85)]


def _gray(shape, seed=0):
    g = np.random.default_rng(seed).uniform(0, 255, shape)
    return g.astype(np.float32)


def _int_gray(shape, seed=0):
    """Integer-valued gray, what the fixed chain's kernels receive."""
    g = np.random.default_rng(seed).integers(0, 256, shape)
    return g.astype(np.float32)


@pytest.mark.parametrize("shape", SCENES)
@pytest.mark.parametrize("mode", ["sector", "cordic"])
def test_dense_grad_hist_plain_matches_pallas(mode, shape):
    g = _gray(shape)
    want = np.asarray(j_grad_hist(jnp.asarray(g), mode=mode))
    got = dense_grad_hist_plain(torch.from_numpy(g), mode=mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("hist_shape", [(1, 12, 16, 9), (2, 19, 10, 9)])
@pytest.mark.parametrize("mode", ["rsqrt", "nr"])
def test_dense_block_norm_plain_matches_pallas(mode, hist_shape):
    # 19 cell rows: 18 block rows against 16-row slabs (one ragged slab)
    h = np.random.default_rng(1).uniform(0, 500, hist_shape) \
        .astype(np.float32)
    h[0, 0] = 0.0                                    # empty cells
    want = np.asarray(j_block_norm(jnp.asarray(h), mode=mode))
    got = dense_block_norm_plain(torch.from_numpy(h), mode=mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("shape", SCENES)
@pytest.mark.parametrize("mode", ["sector", "cordic"])
def test_dense_fused_hog_plain_matches_pallas(mode, shape):
    # 11 and 6 block rows against the reference's 8-row slabs
    g = _gray(shape, seed=2)
    want = np.asarray(j_fused(jnp.asarray(g), mode=mode))
    got = dense_fused_hog_plain(torch.from_numpy(g), mode=mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-5), ("bf16", 1e-4)])
def test_score_matmul_plain_matches_pallas(dtype, atol):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 0.5, (77, 36)).astype(np.float32)
    w = rng.normal(0, 0.02, (36, 105)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    want = np.asarray(j_score_matmul(jnp.asarray(x).astype(jdt),
                                     jnp.asarray(w).astype(jdt)))
    got = score_matmul_plain(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(w).to(tdt))
    assert got.dtype == torch.float32       # f32 out from bf16 in
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("shape", SCENES)
def test_dense_grad_hist_fixed_plain_equals_pallas(shape):
    g = _int_gray(shape, seed=5)
    want = np.asarray(j_grad_hist(jnp.asarray(g), mode="fixed"))
    got = dense_grad_hist_plain(torch.from_numpy(g), mode="fixed")
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_grad_hist_fixed_exact_on_max_contrast_checkerboard():
    """The 130x3842 checkerboard of tests/test_fixed_point.py:199: every
    gradient at full contrast, the int16 cell bound's worst real case;
    an overflow would wrap and break equality."""
    h, w = 130, 3842
    yy, xx = np.mgrid[0:h, 0:w]
    g = ((((yy // 2 + xx // 2) % 2) * 255).astype(np.float32))[None]
    want = np.asarray(j_grad_hist(jnp.asarray(g), mode="fixed"))
    got = dense_grad_hist_plain(torch.from_numpy(g), mode="fixed").numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < int(got.max()) < 2 ** 15


@pytest.mark.parametrize("shape", [(1, 98, 130), (2, 154, 82)])
def test_dense_block_norm_fixed_plain_matches_pallas(shape):
    # 19 cell rows: 18 block rows against 16-row slabs (one ragged slab)
    hist = np.array(j_grad_hist(jnp.asarray(_int_gray(shape, seed=6)),
                                mode="fixed"))
    hist[0, 0] = 0                                    # empty cells
    want = np.asarray(j_block_norm(jnp.asarray(hist), mode="fixed"))
    got = dense_block_norm_plain(torch.from_numpy(hist), mode="fixed")
    assert got.shape == want.shape and got.dtype == torch.float32
    _assert_one_code_step(got.numpy(), want)


@pytest.mark.parametrize("shape", SCENES)
def test_dense_fused_hog_fixed_plain_matches_pallas(shape):
    g = _int_gray(shape, seed=7)
    want = np.asarray(j_fused(jnp.asarray(g), mode="fixed"))
    got = dense_fused_hog_plain(torch.from_numpy(g), mode="fixed").numpy()
    assert got.shape == want.shape
    _assert_one_code_step(got, want)


@pytest.mark.parametrize("m", [1, 77, 300])
def test_score_matmul_int8_plain_equals_pallas(m):
    rng = np.random.default_rng(m)
    q = rng.integers(-127, 128, (m, 36)).astype(np.int8)
    w = rng.integers(-127, 128, (36, 105)).astype(np.int8)
    q[0, :], w[:, 0] = 127, -127        # the extreme sum, -36 * 127^2
    want = np.asarray(j_score_int8(jnp.asarray(q), jnp.asarray(w)))
    got = score_matmul_int8_plain(torch.from_numpy(q), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), q.astype(np.int64) @ w.astype(np.int64))
    assert int(got[0, 0]) == -36 * 127 ** 2


def test_wrappers_run_plain_version_on_cpu_without_counting():
    g = torch.from_numpy(_gray((1, 50, 66), seed=4))
    kernels.reset_launches()
    h = dense_grad_hist(g, mode="cordic")
    torch.testing.assert_close(h, dense_grad_hist_plain(g, mode="cordic"),
                               rtol=0, atol=0)
    torch.testing.assert_close(dense_block_norm(h, mode="nr"),
                               dense_block_norm_plain(h, mode="nr"),
                               rtol=0, atol=0)
    torch.testing.assert_close(dense_fused_hog(g), dense_fused_hog_plain(g),
                               rtol=0, atol=0)
    x = torch.rand(10, 36)
    w = torch.rand(36, 105)
    torch.testing.assert_close(score_matmul(x, w), score_matmul_plain(x, w),
                               rtol=0, atol=0)
    gi = torch.round(g)
    hf = dense_grad_hist(gi, mode="fixed")
    assert hf.dtype == torch.int16
    assert torch.equal(hf, dense_grad_hist_plain(gi, mode="fixed"))
    assert torch.equal(dense_block_norm(hf, mode="fixed"),
                       dense_block_norm_plain(hf, mode="fixed"))
    assert torch.equal(dense_fused_hog(gi, mode="fixed"),
                       dense_fused_hog_plain(gi, mode="fixed"))
    q = torch.randint(-127, 128, (10, 36), dtype=torch.int8)
    wq = torch.randint(-127, 128, (36, 105), dtype=torch.int8)
    assert torch.equal(score_matmul_int8(q, wq),
                       score_matmul_int8_plain(q, wq))
    # launches count kernel launches only
    assert kernels.launch_counts() == {k: 0 for k in kernels.wrappers()}


def test_wrappers_raise_on_other_devices_and_bad_inputs():
    """A tensor that is not on the CPU gets the kernel or an error, never
    the plain version: a 'meta' tensor raises."""
    meta = torch.empty((1, 50, 66), device="meta")
    with pytest.raises(ValueError, match="device"):
        dense_grad_hist(meta)
    with pytest.raises(ValueError, match="device"):
        dense_fused_hog(meta)
    with pytest.raises(ValueError, match="device"):
        dense_block_norm(torch.empty((1, 5, 6, 9), device="meta"))
    with pytest.raises(ValueError, match="device"):
        score_matmul(torch.empty((4, 36), device="meta"),
                     torch.empty((36, 105), device="meta"))
    with pytest.raises(ValueError, match="float32"):
        dense_grad_hist(torch.zeros((1, 50, 66), dtype=torch.float64))
    with pytest.raises(ValueError, match="float32"):
        dense_block_norm(torch.zeros((5, 6, 9)))
    with pytest.raises(ValueError, match="chain"):
        score_matmul(torch.zeros(4, 36), torch.zeros(35, 105))
    with pytest.raises(ValueError, match="bf16"):
        score_matmul(torch.zeros(4, 36), torch.zeros(36, 105,
                                                     dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="mode"):
        dense_grad_hist(torch.zeros((1, 50, 66)), mode="atan")
    with pytest.raises(ValueError, match="norm flavor"):
        dense_block_norm(torch.zeros((1, 5, 6, 9)), mode="l1")
    # the fixed flavor takes int16 histograms, the float flavors f32
    with pytest.raises(ValueError, match="int16"):
        dense_block_norm(torch.zeros((1, 5, 6, 9)), mode="fixed")
    with pytest.raises(ValueError, match="float32"):
        dense_block_norm(torch.zeros((1, 5, 6, 9), dtype=torch.int16))
    with pytest.raises(ValueError, match="device"):
        dense_block_norm(torch.empty((1, 5, 6, 9), dtype=torch.int16,
                                     device="meta"), mode="fixed")
    q = torch.zeros((4, 36), dtype=torch.int8)
    wq = torch.zeros((36, 105), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        score_matmul_int8(q.float(), wq)
    with pytest.raises(ValueError, match="int8"):
        score_matmul_int8(q, wq.to(torch.int16))
    with pytest.raises(ValueError, match="chain"):
        score_matmul_int8(q, wq[:35])
    with pytest.raises(ValueError, match="device"):
        score_matmul_int8(q.to("meta"), wq.to("meta"))
    with pytest.raises(ValueError, match=" on "):
        score_matmul_int8(q.to("meta"), wq)


def test_build_names_every_kernel_source():
    for name, src in build.SOURCES.items():
        assert (build.CSRC / src).is_file(), src
        assert build.library_path(name).parent == build.BUILD_DIR
    assert "--fmad=false" in build.NVCC_FLAGS
    assert not any("fast-math" in f or "fast_math" in f
                   for f in build.NVCC_FLAGS)


# ------------------------------------------------------ window kernels

WINDOWS = (11, 130, 66)       # a full 8-window slab and a ragged one
MODES = [("sector", "rsqrt"), ("cordic", "nr"), ("fixed", "fixed")]


def _window_gray(kind, seed=6):
    return (_int_gray if kind == "int" else _gray)(WINDOWS, seed)


@pytest.mark.parametrize("mode,kind", [("sector", "float"),
                                       ("sector", "int"),
                                       ("cordic", "float"),
                                       ("cordic", "int"),
                                       ("fixed", "int")])
def test_hog_gradient_plain_matches_pallas(mode, kind):
    g = _window_gray(kind)
    wm, wb = (np.asarray(a) for a in j_hog_gradient(jnp.asarray(g),
                                                    mode=mode))
    tm, tb = hog_gradient_plain(torch.from_numpy(g), mode)
    assert tm.dtype == (torch.int32 if mode == "fixed" else torch.float32)
    assert tuple(tm.shape) == wm.shape == (11, 128, 64)
    np.testing.assert_array_equal(tb.numpy(), wb)
    rtol = 1e-6 if kind == "float" else 0
    np.testing.assert_allclose(tm.numpy(), wm, rtol=rtol, atol=0)


@pytest.mark.parametrize("mode", ["sector", "cordic", "fixed"])
def test_cell_hist_plain_matches_pallas(mode):
    """Both get the same magnitudes and bins (the Pallas gradient's)."""
    g = _window_gray("int" if mode == "fixed" else "float", seed=7)
    wm, wb = j_hog_gradient(jnp.asarray(g), mode=mode)
    want = np.asarray(j_cell_hist(wm, wb))
    got = cell_hist_plain(torch.from_numpy(np.array(wm)),
                          torch.from_numpy(np.array(wb)))
    assert tuple(got.shape) == want.shape == (11, 16, 8, 9)
    if mode == "fixed":
        assert got.dtype == torch.int16 and want.dtype == np.int16
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode,norm", MODES)
def test_window_block_norm_plain_matches_pallas(mode, norm):
    g = _window_gray("int" if mode == "fixed" else "float", seed=8)
    hist = j_cell_hist(*j_hog_gradient(jnp.asarray(g), mode=mode))
    h = np.array(hist)
    h[0, 0] = 0                                       # empty cells
    want = np.asarray(j_win_block_norm(jnp.asarray(h), mode=norm))
    got = block_norm_plain(torch.from_numpy(h), mode=norm)
    assert got.dtype == torch.float32 and want.shape == (11, 15, 7, 36)
    if norm == "fixed":
        _assert_one_code_step(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("mode", ["sector", "cordic", "fixed"])
def test_window_fused_hog_plain_matches_pallas(mode):
    g = _window_gray("int" if mode == "fixed" else "float", seed=9)
    want = np.asarray(j_win_fused(jnp.asarray(g), mode=mode))
    got = fused_hog_plain(torch.from_numpy(g), mode=mode).numpy()
    assert got.shape == want.shape == (11, 3780)
    if mode == "fixed":
        _assert_one_code_step(got.reshape(11, -1, 36),
                              want.reshape(11, -1, 36))
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("b", [1, 11, 130])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_svm_scores_plain_matches_pallas(dtype, b):
    """bf16 features against f32 weights: each feature upcast exactly,
    f32 accumulation, as the reference kernel promotes them."""
    rng = np.random.default_rng(b)
    f = rng.uniform(-1, 1, (b, 3780)).astype(np.float32)
    w = rng.normal(0, 0.05, 3780).astype(np.float32)
    bias = np.float32(0.3)
    ft = torch.from_numpy(f)
    if dtype == "bf16":
        ft = ft.to(torch.bfloat16)
        fj = jnp.asarray(ft.float().numpy()).astype(jnp.bfloat16)
    else:
        fj = jnp.asarray(f)
    want = np.asarray(j_svm_scores(fj, jnp.asarray(w), jnp.asarray(bias)))
    got = svm_scores_plain(ft, torch.from_numpy(w), torch.tensor(bias))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_window_wrappers_run_plain_version_on_cpu_without_counting():
    g = torch.from_numpy(_gray((3, 130, 66), seed=10))
    gi = torch.round(g)
    kernels.reset_launches()
    for mode, norm in MODES:
        x = gi if mode == "fixed" else g
        mag, b = hog_gradient(x, mode)
        pm, pb = hog_gradient_plain(x, mode)
        assert torch.equal(mag, pm) and torch.equal(b, pb)
        h = cell_hist(mag, b)
        assert torch.equal(h, cell_hist_plain(mag, b))
        assert torch.equal(block_norm(h, mode=norm),
                           block_norm_plain(h, mode=norm))
        assert torch.equal(fused_hog(x, mode=mode),
                           fused_hog_plain(x, mode=mode))
    f = torch.rand(4, 3780)
    w = torch.rand(3780)
    bias = torch.tensor(0.5)
    assert torch.equal(svm_scores(f, w, bias), svm_scores_plain(f, w, bias))
    assert kernels.launch_counts() == {k: 0 for k in kernels.wrappers()}


def test_window_wrappers_raise_on_other_devices_and_bad_inputs():
    meta = torch.empty((2, 130, 66), device="meta")
    with pytest.raises(ValueError, match="device"):
        hog_gradient(meta)
    with pytest.raises(ValueError, match="device"):
        fused_hog(meta)
    with pytest.raises(ValueError, match="device"):
        cell_hist(torch.empty((2, 128, 64), device="meta"),
                  torch.empty((2, 128, 64), dtype=torch.int32,
                              device="meta"))
    with pytest.raises(ValueError, match="device"):
        block_norm(torch.empty((2, 16, 8, 9), device="meta"))
    with pytest.raises(ValueError, match="device"):
        svm_scores(torch.empty((2, 3780), device="meta"),
                   torch.empty(3780, device="meta"),
                   torch.empty((), device="meta"))
    with pytest.raises(ValueError, match=" on "):
        svm_scores(torch.zeros(2, 3780), torch.zeros(3780),
                   torch.empty((), device="meta"))
    with pytest.raises(ValueError, match="float32"):
        hog_gradient(torch.zeros((2, 130, 66), dtype=torch.float64))
    with pytest.raises(ValueError, match="mode"):
        hog_gradient(torch.zeros((2, 130, 66)), mode="atan")
    with pytest.raises(ValueError, match="whole number"):
        cell_hist(torch.zeros((2, 128, 60)),
                  torch.zeros((2, 128, 60), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        cell_hist(torch.zeros((2, 128, 64)), torch.zeros((2, 128, 64)))
    with pytest.raises(ValueError, match="int16"):
        block_norm(torch.zeros((2, 16, 8, 9)), mode="fixed")
    with pytest.raises(ValueError, match="norm flavor"):
        block_norm(torch.zeros((2, 16, 8, 9)), mode="l1")
    with pytest.raises(ValueError, match="chain"):
        svm_scores(torch.zeros(2, 3780), torch.zeros(3779), torch.zeros(()))
    with pytest.raises(ValueError, match="f32 weights"):
        svm_scores(torch.zeros(2, 3780), torch.zeros(3780,
                                                      dtype=torch.bfloat16),
                   torch.zeros(()))
    with pytest.raises(ValueError, match="block"):
        fused_hog(torch.zeros((2, 17, 66)))
