"""Fused HOG in one kernel, per layout; only the gray and the blocks
touch device memory. In the fixed mode the gray is integer-valued, the
cell histograms are int16 and the blocks lie on their per-block int8
grid.

  * ``dense_fused_hog`` -- a scene: (B, H, W) f32 gray ->
    (B, ch-1, cw-1, 36) f32 blocks. Replaces the TPU kernel
    repro/kernels/fused_hog.py:137, CUDA source csrc/dense_fused_hog.cu.
  * ``fused_hog`` -- a batch of windows: (B, 130, 66) f32 gray ->
    (B, 3780) f32 descriptors in collate order. Replaces the TPU kernel
    repro/kernels/fused_hog.py:75, CUDA source csrc/fused_hog.cu.

The dense kernel, bound on the H100: memory, about half a microsecond
per 640x480 level (1.2 MB of gray in, 0.65 MB of blocks out at
3.35 TB/s), well below a launch. Against the two-kernel backend it saves the histogram round trip
and one launch per level. One thread block owns a 4x8 tile of blocks:
it computes the 5x9 cell histograms the tile needs into shared memory
(one cell row and column recomputed at tile seams, as the TPU kernel
recomputes one cell row per slab) and normalizes from there; edge tiles
mask, so ragged grids need no padded gather.

The window kernel, bound on the H100: bytes -- a window reads 34.3 KB and
writes 15.1 KB, 88 us for B = 5,949 windows at 3.35 TB/s. One thread
block per window holds its gray (34.3 KB) and its 16x8x9 cell
histograms in shared memory, stages the normalized blocks in the gray's
space and writes the 3,780 floats in one coalesced copy.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (``dense_fused_hog_plain``, ``fused_hog_plain``) for a CPU
tensor; nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import numerics as N
from . import build
from .dense_block_norm import (dense_block_norm_plain,
                               norm_code)
from .dense_grad_hist import dense_grad_hist_plain
from .mag_bin import mode_code

Tensor = torch.Tensor

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def _norm_flavor(mode: str) -> str:
    # the normalize tail is derived from the mode through SPECS, as in
    # repro/kernels/fused_hog.py:_norm_flavor
    return N.SPECS[mode].norm


def dense_fused_hog_plain(gray: Tensor, cell: int = 8, block: int = 2,
                          bins: int = 9, eps: float = 1e-2,
                          mode: str = "sector") -> Tensor:
    """The same function in plain tensor ops, on any device."""
    hist = dense_grad_hist_plain(gray, cell, bins, mode)
    return dense_block_norm_plain(hist, block, eps, _norm_flavor(mode))


def dense_fused_hog(gray: Tensor, cell: int = 8, block: int = 2,
                    bins: int = 9, eps: float = 1e-2,
                    mode: str = "sector") -> Tensor:
    """(B, H, W) f32 dense scene -> (B, bh, bw, block^2*bins) f32."""
    code = mode_code(mode)
    ncode = norm_code(_norm_flavor(mode))
    if gray.dim() != 3 or gray.dtype != torch.float32:
        raise ValueError(f"dense_fused_hog takes (B, H, W) float32, got "
                         f"{tuple(gray.shape)} {gray.dtype}")
    B, H, W = gray.shape
    ch, cw = (H - 2) // cell, (W - 2) // cell
    if ch < block or cw < block:
        raise ValueError(f"scene {tuple(gray.shape)} holds no whole block")
    if gray.device.type == "cpu":
        return dense_fused_hog_plain(gray, cell, block, bins, eps, mode)
    if gray.device.type != "cuda":
        raise ValueError(f"dense_fused_hog: unsupported device {gray.device}")
    if (cell, block, bins) != (8, 2, 9):
        raise ValueError("the CUDA kernel is built for 8-px cells, 2x2 "
                         "blocks, 9 bins")
    if not gray.is_contiguous():
        raise ValueError("dense_fused_hog: gray must be contiguous")
    out = torch.empty((B, ch - 1, cw - 1, 36), dtype=torch.float32,
                      device=gray.device)
    build.launch("dense_fused_hog", _ARGTYPES, gray, gray.data_ptr(),
                 out.data_ptr(), B, H, W,
                 N.norm_eps_squared(eps, _norm_flavor(mode)), code, ncode)
    dense_fused_hog.launches += 1
    return out


dense_fused_hog.launches = 0


def window_smem_bytes(H: int, W: int, mode: str) -> int:
    """Shared memory of one window in csrc/fused_hog.cu: the gray (or the
    staged blocks at a 37-float row stride, whichever is larger), then
    the cell histograms (int16 in the fixed mode)."""
    ch, cw = (H - 2) // 8, (W - 2) // 8
    region = max(H * W, (ch - 1) * (cw - 1) * 37)
    return 4 * region + (2 if mode == "fixed" else 4) * ch * cw * 9


def fused_hog_plain(gray: Tensor, cell: int = 8, block: int = 2,
                    bins: int = 9, eps: float = 1e-2,
                    mode: str = "sector") -> Tensor:
    """The same function in plain tensor ops, on any device: the dense
    chain on each window, collated to (B, n_features)."""
    out = dense_fused_hog_plain(gray, cell, block, bins, eps, mode)
    return out.reshape(out.shape[0], -1)


def fused_hog(gray: Tensor, cell: int = 8, block: int = 2, bins: int = 9,
              eps: float = 1e-2, mode: str = "sector") -> Tensor:
    """(B, H, W) f32 windows -> (B, (ch-1)*(cw-1)*block^2*bins) f32
    descriptors, blocks row-major then their values."""
    code = mode_code(mode)
    ncode = norm_code(_norm_flavor(mode))
    if gray.dim() != 3 or gray.dtype != torch.float32:
        raise ValueError(f"fused_hog takes (B, H, W) float32, got "
                         f"{tuple(gray.shape)} {gray.dtype}")
    B, H, W = gray.shape
    ch, cw = (H - 2) // cell, (W - 2) // cell
    if ch < block or cw < block:
        raise ValueError(f"window {tuple(gray.shape)} holds no whole block")
    if gray.device.type == "cpu":
        return fused_hog_plain(gray, cell, block, bins, eps, mode)
    if gray.device.type != "cuda":
        raise ValueError(f"fused_hog: unsupported device {gray.device}")
    if (cell, block, bins) != (8, 2, 9):
        raise ValueError("the CUDA kernel is built for 8-px cells, 2x2 "
                         "blocks, 9 bins")
    if window_smem_bytes(H, W, mode) > build.SMEM_DEFAULT:
        raise ValueError(f"a {H}x{W} window needs "
                         f"{window_smem_bytes(H, W, mode)} B of shared "
                         f"memory, over {build.SMEM_DEFAULT}")
    if not gray.is_contiguous():
        raise ValueError("fused_hog: gray must be contiguous")
    out = torch.empty((B, (ch - 1) * (cw - 1) * 36), dtype=torch.float32,
                      device=gray.device)
    build.launch("fused_hog", _ARGTYPES, gray, gray.data_ptr(),
                 out.data_ptr(), B, H, W,
                 N.norm_eps_squared(eps, _norm_flavor(mode)), code, ncode)
    fused_hog.launches += 1
    return out


fused_hog.launches = 0
