"""Per-cell orientation histograms over a batch of windows (HOG stage 3b):
mag (B, Ha, Wa) f32 + bin (B, Ha, Wa) int32 -> (B, Ha/8, Wa/8, 9) f32;
int32 magnitudes (the fixed chain) accumulate in int32 and store int16.

Replaces the TPU kernel repro/kernels/cell_hist.py:46 (``cell_hist``),
CUDA source csrc/cell_hist.cu.

Bound on the H100: bytes -- a 128x64 window reads 65.5 KB and writes
4.6 KB, 125 us for B = 5,949 windows at 3.35 TB/s. 8 lanes per cell, one
pixel row each, select-and-add into 9 register bins, then warp shuffles
in a fixed order; the TPU kernel's one-hot contraction has no use here.

``cell_hist`` launches the kernel for a CUDA tensor and runs the plain
version ``cell_hist_plain`` for a CPU tensor; nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.hog import HOGConfig, cell_histograms
from . import build

Tensor = torch.Tensor

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def cell_hist_plain(mag: Tensor, bin_idx: Tensor, cell: int = 8,
                    bins: int = 9) -> Tensor:
    """The same function in plain tensor ops, on any device."""
    ha, wa = mag.shape[-2], mag.shape[-1]
    geom = HOGConfig(window_h=ha + 2, window_w=wa + 2, cell=cell, bins=bins)
    return cell_histograms(mag, bin_idx, geom)


def cell_hist(mag: Tensor, bin_idx: Tensor, cell: int = 8,
              bins: int = 9) -> Tensor:
    """(B, Ha, Wa) mag + bin -> (B, Ha/cell, Wa/cell, bins) histograms,
    f32, or int16 for int32 magnitudes."""
    if mag.dim() != 3 or mag.shape != bin_idx.shape:
        raise ValueError(f"cell_hist takes (B, Ha, Wa) mag and bin of one "
                         f"shape, got {tuple(mag.shape)} and "
                         f"{tuple(bin_idx.shape)}")
    if mag.dtype not in (torch.float32, torch.int32) \
            or bin_idx.dtype != torch.int32:
        raise ValueError(f"cell_hist takes float32 or int32 mag and int32 "
                         f"bins, got {mag.dtype} and {bin_idx.dtype}")
    B, ha, wa = mag.shape
    if ha % cell or wa % cell or ha == 0 or wa == 0:
        raise ValueError(f"{ha}x{wa} is not a whole number of {cell}-px "
                         f"cells")
    if mag.device != bin_idx.device:
        raise ValueError(f"cell_hist inputs on {mag.device} and "
                         f"{bin_idx.device}")
    if mag.device.type == "cpu":
        return cell_hist_plain(mag, bin_idx, cell, bins)
    if mag.device.type != "cuda":
        raise ValueError(f"cell_hist: unsupported device {mag.device}")
    if (cell, bins) != (8, 9):
        raise ValueError("the CUDA kernel is built for 8-px cells, 9 bins")
    if not (mag.is_contiguous() and bin_idx.is_contiguous()):
        raise ValueError("cell_hist: inputs must be contiguous")
    integer = mag.dtype == torch.int32
    out = torch.empty((B, ha // cell, wa // cell, bins),
                      dtype=torch.int16 if integer else torch.float32,
                      device=mag.device)
    build.launch("cell_hist", _ARGTYPES, mag, mag.data_ptr(),
                 bin_idx.data_ptr(), out.data_ptr(), B, ha, wa, int(integer))
    cell_hist.launches += 1
    return out


cell_hist.launches = 0
