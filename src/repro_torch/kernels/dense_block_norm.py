"""Dense 2x2-block L2 normalization (eq. 5) over a scene's cell grid:
(B, ch, cw, 9) f32 -> (B, ch-1, cw-1, 36) f32; in the fixed flavor
(B, ch, cw, 9) int16 -> f32 blocks on their per-block int8 grid.

Replaces the TPU kernel repro/kernels/dense_block_norm.py:41
(``dense_block_norm``), CUDA source csrc/dense_block_norm.cu.

Bound on the H100: memory, far below a launch at the detector's sizes
(0.8 MB at a 640x480 level, a quarter of a microsecond at 3.35 TB/s).
One thread per block gathers the four cells in the reference's order
(0,0), (0,1), (1,0), (1,1) and applies the shared tail
(csrc/finish_blocks.cuh), so there are no row slabs and no shifted views.

``dense_block_norm`` launches the kernel for a CUDA tensor and runs the
plain version ``dense_block_norm_plain`` for a CPU tensor; nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import numerics as N
from ..core.hog import HOGConfig, gather_blocks
from . import build

Tensor = torch.Tensor

#: norm flavor -> the value the CUDA launchers take (csrc/finish_blocks.cuh)
NORM_CODES = {"rsqrt": 0, "nr": 1, "fixed": 2}

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def norm_code(mode: str) -> int:
    """Validate a norm flavor and return its launcher code."""
    try:
        return NORM_CODES[mode]
    except KeyError:
        raise ValueError(f"unknown norm flavor {mode!r}; expected one of "
                         f"{sorted(NORM_CODES)}") from None


def dense_block_norm_plain(hist: Tensor, block: int = 2, eps: float = 1e-2,
                           mode: str = "rsqrt") -> Tensor:
    """The same function in plain tensor ops, on any device."""
    v = gather_blocks(hist, HOGConfig(block=block, bins=hist.shape[-1]))
    return N.finish_blocks(v, eps, mode)


def dense_block_norm(hist: Tensor, block: int = 2, eps: float = 1e-2,
                     mode: str = "rsqrt") -> Tensor:
    """(B, ch, cw, bins) f32 (int16 for mode="fixed") ->
    (B, bh, bw, block^2*bins) f32."""
    code = norm_code(mode)
    dtype = torch.int16 if mode == "fixed" else torch.float32
    if hist.dim() != 4 or hist.dtype != dtype:
        raise ValueError(f"dense_block_norm {mode} takes (B, ch, cw, bins) "
                         f"{dtype}, got {tuple(hist.shape)} {hist.dtype}")
    B, ch, cw, bins = hist.shape
    if ch < block or cw < block:
        raise ValueError(f"cell grid {(ch, cw)} holds no whole block")
    if hist.device.type == "cpu":
        return dense_block_norm_plain(hist, block, eps, mode)
    if hist.device.type != "cuda":
        raise ValueError(f"dense_block_norm: unsupported device {hist.device}")
    if (block, bins) != (2, 9):
        raise ValueError("the CUDA kernel is built for 2x2 blocks, 9 bins")
    if not hist.is_contiguous():
        raise ValueError("dense_block_norm: hist must be contiguous")
    out = torch.empty((B, ch - 1, cw - 1, 36), dtype=torch.float32,
                      device=hist.device)
    build.launch("dense_block_norm", _ARGTYPES, hist, hist.data_ptr(),
                 out.data_ptr(), B, ch, cw, N.norm_eps_squared(eps, mode),
                 code)
    dense_block_norm.launches += 1
    return out


dense_block_norm.launches = 0
