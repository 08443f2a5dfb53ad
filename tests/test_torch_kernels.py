"""Each kernel's plain PyTorch version (repro_torch.kernels.*) against the
JAX Pallas kernel it replaces, run as the JAX package's own tests run it
on the CPU (interpret mode), in every float mode and on ragged slab
shapes. The CUDA kernels themselves run only on the card: chip_smoke.py
holds each against these plain versions there.

Tolerances (absolute unless stated), each set by summation order only:
histograms rtol 1e-5, blocks 5e-5, score_matmul f32 1e-5 and bf16 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dense_block_norm import dense_block_norm as j_block_norm
from repro.kernels.dense_grad_hist import dense_grad_hist as j_grad_hist
from repro.kernels.fused_hog import dense_fused_hog as j_fused
from repro.kernels.svm_matmul import score_matmul as j_score_matmul
from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.dense_block_norm import (dense_block_norm,
                                                  dense_block_norm_plain)
from repro_torch.kernels.dense_grad_hist import (dense_grad_hist,
                                                 dense_grad_hist_plain)
from repro_torch.kernels.fused_hog import dense_fused_hog, dense_fused_hog_plain
from repro_torch.kernels.svm_matmul import score_matmul, score_matmul_plain

# (B, H, W) gray scenes: 12 cell rows against the reference's 8-row
# slabs, and 7 against 8 (one short slab) with an untrimmed width
SCENES = [(1, 98, 130), (2, 59, 85)]


def _gray(shape, seed=0):
    g = np.random.default_rng(seed).uniform(0, 255, shape)
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
    # launches count kernel launches only
    assert kernels.launch_counts() == {k: 0 for k in build.SOURCES}


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
    with pytest.raises(NotImplementedError, match="next slice"):
        dense_fused_hog(torch.zeros((1, 50, 66)), mode="fixed")
    with pytest.raises(NotImplementedError, match="next slice"):
        dense_block_norm(torch.zeros((1, 5, 6, 9)), mode="fixed")


def test_build_names_every_kernel_source():
    for name, src in build.SOURCES.items():
        assert (build.CSRC / src).is_file(), src
        assert build.library_path(name).parent == build.BUILD_DIR
    assert "--fmad=false" in build.NVCC_FLAGS
    assert not any("fast-math" in f or "fast_math" in f
                   for f in build.NVCC_FLAGS)
