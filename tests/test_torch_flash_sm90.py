"""The tensor-core route of the port's flash attention
(csrc/flash_attention_sm90.cu) as far as the CPU can hold it: which calls
the wrapper routes to it, what it asks of the card (shared memory, TMA
layouts), what its source must contain, and the rounding oracle that
chip_smoke.py holds it to on the card, itself held to the Pallas kernel
(interpret mode) with the same 128-key tiles. The kernel runs only on
the card.
"""
import ast
import inspect
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its checks' plain versions)

SRC = build.CSRC / "flash_attention_sm90.cu"


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 16, "sm90"), (torch.bfloat16, 32, "cuda_core"),
    (torch.bfloat16, 8, "cuda_core"), (torch.bfloat16, 96, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 16, "cuda_core")])
def test_route_is_a_function_of_dtype_and_hd(dtype, hd, want):
    assert fa.route(dtype, hd) == want
    assert want in fa.ROUTES


def test_sm90_shared_memory_request_fits_the_opt_in():
    """The wrapper's mirror of Geo<HD>::SMEM: alignment slack, Q, two
    stages of K and V in bf16, five mbarriers. At hd 128 it is 160 KB of
    tiles, over the 48 KB default and under Hopper's 227 KB opt-in."""
    assert fa.smem_bytes_sm90(128) == 1024 + 2 * 128 * (128 + 4 * 128) + 40
    assert fa.smem_bytes_sm90(128) == 164904
    assert fa.smem_bytes_sm90(16) == 1024 + 2 * 16 * 640 + 40
    assert fa.smem_bytes_sm90(128) > build.SMEM_DEFAULT
    assert max(map(fa.smem_bytes_sm90, fa.SM90_HD)) <= build.SMEM_OPTIN
    src = SRC.read_text()
    for name, value in (("BQ", fa.SM90_BLOCK_Q), ("BK", fa.SM90_BLOCK_K),
                        ("STAGES", fa.SM90_STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert re.search(r"SMEM = 1024 \+ BAR_OFF \+ 8 \* \(1 \+ 2 \* STAGES\)",
                     src)
    for hd in fa.SM90_HD:
        assert f"case {hd}: return launch<{hd}>" in src


def test_build_sources_hold_the_sm90_kernel():
    assert build.SOURCES["flash_attention_sm90"] == "flash_attention_sm90.cu"
    assert build.SOURCES["flash_attention"] == "flash_attention.cu"
    assert SRC.exists()
    assert "-lcuda" not in build.NVCC_FLAGS


def test_sm90_source_pins():
    """Tensor cores, TMA, mbarriers and the register split are in the
    source or the header it includes (csrc/sm90_wgmma.cuh, shared with the
    sm90 backward); the softmax uses expf, never __expf; the kernel's name
    holds the symbol the profiler matches for both routes."""
    src = SRC.read_text()
    assert '#include "sm90_wgmma.cuh"' in src
    src += (build.CSRC / "sm90_wgmma.cuh").read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier",
                   "setmaxnreg", "__grid_constant__ CUtensorMap",
                   "cudaGetDriverEntryPoint",
                   "src/repro/kernels/flash_attention.py:86"):
        assert needle in src, needle
    assert "expf(" in src and not re.search(r"__expf\s*\(", src)
    assert "flash_attention_kernel_sm90" in src
    old = (build.CSRC / "flash_attention.cu").read_text()
    assert "flash_attention_kernel(" in old


def test_wrapper_cuda_branch_has_no_try():
    """A build or launch failure of either route raises: no try/except
    between the routes or around a launch."""
    tree = ast.parse(inspect.getsource(fa))
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for name in ("flash_attention", "launch_sm90", "launch_cuda_core",
                 "_count"):
        assert not any(isinstance(n, ast.Try)
                       for n in ast.walk(funcs[name])), name


def _bshd(B, S, n, hd, width=None):
    x = torch.zeros(B, S, n, width or hd, dtype=torch.bfloat16)
    return x[..., :hd].transpose(1, 2)


def test_tma_strides_take_both_prefill_layouts():
    """The (B, S, H, hd) projections transposed, as prefill passes them,
    and contiguous (B, H, S, hd) tensors: element strides of B, heads,
    S; a dimension of size 1 reads as hd."""
    assert fa.tma_strides(_bshd(2, 40, 8, 128)) == [40 * 8 * 128, 128,
                                                     8 * 128]
    c = torch.zeros(2, 8, 40, 16, dtype=torch.bfloat16)
    assert fa.tma_strides(c) == [8 * 40 * 16, 40 * 16, 16]
    assert fa.tma_strides(_bshd(1, 40, 8, 64)) == [64, 64, 8 * 64]


def test_tma_strides_raise_on_layouts_a_map_cannot_describe():
    x = torch.zeros(2, 4, 40, 17, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="base"):
        fa.tma_strides(x[..., 1:])                # 2-byte offset
    with pytest.raises(ValueError, match="16 bytes"):
        fa.tma_strides(_bshd(2, 40, 4, 16, width=20))   # 40-byte rows
    y = torch.zeros(2, 4, 40, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unit-stride"):
        fa.tma_strides(y[..., ::2])


def test_sm90_launch_refuses_what_it_was_not_built_for():
    q = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="sm90"):
        fa.launch_sm90(q, q, q)
    with pytest.raises(ValueError, match="sm90"):
        fa.launch_sm90(*(torch.zeros(1, 2, 8, 128),) * 3)


def test_cpu_bf16_at_sm90_widths_runs_plain_and_counts_no_route():
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, n, 24, 128)).astype(
        np.float32)).bfloat16() for n in (4, 2, 2))
    kernels.reset_launches()
    got = fa.flash_attention(q, k, v)
    torch.testing.assert_close(got, fa.flash_attention_plain(q, k, v),
                               rtol=0, atol=0)
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention.route_launches == {"sm90": 0, "cuda_core": 0}


def test_reset_launches_clears_each_route_count():
    fa.flash_attention.route_launches["sm90"] = 3
    fa.flash_attention.launches = 3
    kernels.reset_launches()
    assert fa.flash_attention.route_launches == dict.fromkeys(fa.ROUTES, 0)
    assert kernels.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("block_k", [64, 128])
def test_bf16_matched_non_causal_is_the_pallas_kernels_rounding(block_k):
    """chip_smoke.py also holds the sm90 route to flash_bf16_matched on
    non-causal shapes: the Pallas kernel with the same key tiles, in
    interpret mode, meets the same limit."""
    rng = np.random.default_rng(7)
    arrays = [rng.normal(size=(1, n, 256, 32)).astype(np.float32)
              for n in (4, 2, 2)]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    want = chip_smoke.flash_bf16_matched(torch, q, k, v, block_k=block_k,
                                         causal=False).numpy()
    got = np.asarray(j_flash(*(jnp.asarray(a, jnp.bfloat16)
                               for a in arrays), causal=False,
                             block_q=block_k, block_k=block_k,
                             interpret=True), np.float32)
    atol, rtol = chip_smoke.FLASH_MATCHED_TOL
    diff = np.abs(got - want)
    assert (diff <= atol + rtol * np.abs(want)).all(), diff.max()


def test_bf16_matched_tile_width_changes_the_rounding():
    """The oracle's block_k is not cosmetic: with 64-key and 128-key tiles
    p is rounded against other running maxima, so the two oracles differ
    where a row's max rises in its second 64 keys."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, n, 128, 32)).astype(
        np.float32)).bfloat16() for n in (2, 1, 1))
    a = chip_smoke.flash_bf16_matched(torch, q, k, v, block_k=64)
    b = chip_smoke.flash_bf16_matched(torch, q, k, v, block_k=128)
    assert a.shape == b.shape == (1, 2, 128, 32)
    assert not torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2)


def test_chip_smoke_route_sources_are_the_wrappers():
    """chip_smoke.py's per-route sources name what the wrapper and
    build.py use."""
    assert set(chip_smoke.FLASH_SOURCES) == set(fa.ROUTES)
    root = pathlib.Path(__file__).resolve().parents[1]
    for r, path in chip_smoke.FLASH_SOURCES.items():
        assert (root / path).exists(), path
    assert chip_smoke.FLASH_SOURCES["sm90"].endswith(
        build.SOURCES["flash_attention_sm90"])
    assert chip_smoke.KERNELS["flash_attention"][0] == \
        chip_smoke.FLASH_SOURCES[chip_smoke.MAIN_MODE["flash_attention"]]
    assert all(fa.route(torch.bfloat16, hd) == "cuda_core"
               for *_, hd, _, _ in chip_smoke.FLASH_OTHER_HD)


def test_every_source_is_launched_by_a_wrapper():
    """Each CUDA source has a wrapper that launches it and counts it: one
    per kernel, flash_attention's two sources behind its one wrapper and
    flash_attention_bwd's two behind its."""
    assert set(build.SOURCES) == set(kernels.wrappers()) | {
        "flash_attention_sm90", "flash_attention_bwd_sm90"}
    assert set(fa.ROUTES) == set(fa.flash_attention.route_launches)
    assert set(fa.ROUTES) == set(fa.flash_attention_bwd.route_launches)
