"""Window block L2 normalization (HOG stages 4-5, eq. 5): (B, ch, cw, 9)
f32 cell histograms -> (B, ch-1, cw-1, 36) f32 blocks; in the fixed
flavor int16 histograms -> f32 blocks on their per-block int8 grid.

Replaces the TPU kernel repro/kernels/block_norm.py:41 (``block_norm``),
CUDA source csrc/block_norm.cu.

Bound on the H100: bytes -- a window reads 4.6 KB and writes 15.1 KB,
35 us for B = 5,949 windows at 3.35 TB/s. One thread block per window
stages its histograms and its normalized blocks in shared memory, so
both the reads and the 15 KB write are coalesced; one thread per block
gathers and normalizes (csrc/finish_blocks.cuh).

``block_norm`` launches the kernel for a CUDA tensor and runs the plain
version ``block_norm_plain`` for a CPU tensor; nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import numerics as N
from . import build
from .dense_block_norm import dense_block_norm_plain, norm_code

Tensor = torch.Tensor

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def smem_bytes(ch: int, cw: int) -> int:
    """Shared memory of one window in csrc/block_norm.cu: the histograms
    as f32, then the blocks at a 37-float row stride."""
    return 4 * (ch * cw * 9 + (ch - 1) * (cw - 1) * 37)


def block_norm_plain(hist: Tensor, block: int = 2, eps: float = 1e-2,
                     mode: str = "rsqrt") -> Tensor:
    """The same function in plain tensor ops, on any device: gather the
    2x2 cells of every block, then the normalize tail. The window and
    dense layouts compute one function; only the kernels differ."""
    return dense_block_norm_plain(hist, block, eps, mode)


def block_norm(hist: Tensor, block: int = 2, eps: float = 1e-2,
               mode: str = "rsqrt") -> Tensor:
    """(B, ch, cw, bins) f32 (int16 for mode="fixed") ->
    (B, ch-1, cw-1, block^2*bins) f32."""
    code = norm_code(mode)
    dtype = torch.int16 if mode == "fixed" else torch.float32
    if hist.dim() != 4 or hist.dtype != dtype:
        raise ValueError(f"block_norm {mode} takes (B, ch, cw, bins) "
                         f"{dtype}, got {tuple(hist.shape)} {hist.dtype}")
    B, ch, cw, bins = hist.shape
    if ch < block or cw < block:
        raise ValueError(f"cell grid {(ch, cw)} holds no whole block")
    if hist.device.type == "cpu":
        return block_norm_plain(hist, block, eps, mode)
    if hist.device.type != "cuda":
        raise ValueError(f"block_norm: unsupported device {hist.device}")
    if (block, bins) != (2, 9):
        raise ValueError("the CUDA kernel is built for 2x2 blocks, 9 bins")
    if smem_bytes(ch, cw) > build.SMEM_DEFAULT:
        raise ValueError(f"a {ch}x{cw}-cell window needs "
                         f"{smem_bytes(ch, cw)} B of shared memory, over "
                         f"{build.SMEM_DEFAULT}")
    if not hist.is_contiguous():
        raise ValueError("block_norm: hist must be contiguous")
    out = torch.empty((B, ch - 1, cw - 1, 36), dtype=torch.float32,
                      device=hist.device)
    build.launch("block_norm", _ARGTYPES, hist, hist.data_ptr(),
                 out.data_ptr(), B, ch, cw, N.norm_eps_squared(eps, mode),
                 code)
    block_norm.launches += 1
    return out


block_norm.launches = 0
