"""Dense gradient -> magnitude/bin -> cell histograms over a scene:
(B, H, W) f32 gray -> (B, ch, cw, 9), H = gh + 2 with gh whole cells; f32
histograms in the float modes, int16 in the fixed mode (integer-valued
gray in, int32 sums stored as int16).

Replaces the TPU kernel repro/kernels/dense_grad_hist.py:62
(``dense_grad_hist``), CUDA source csrc/dense_grad_hist.cu.

Bound on the H100: memory, and at the detector's sizes not even that --
a 640x480 level moves 1.4 MB (under half a microsecond at 3.35 TB/s), so
one launch's overhead dominates. The kernel gives every cell 8 lanes,
one per pixel row, reads the 10x10 gray patch straight from global
memory (the TPU kernel's row-shifted halo views become overlapping reads
through the cache) and sums the 8 partial histograms with warp shuffles.

``dense_grad_hist`` launches the kernel for a CUDA tensor and runs the
plain version ``dense_grad_hist_plain`` for a CPU tensor; nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.hog import HOGConfig, cell_histograms, gradients
from . import build
from .mag_bin import mag_bin_impl, mode_code

Tensor = torch.Tensor

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _geometry(gray: Tensor, cell: int):
    B, H, W = gray.shape
    gh = (H - 2) // cell * cell
    return B, gh // cell, (W - 2) // cell, gh


def dense_grad_hist_plain(gray: Tensor, cell: int = 8, bins: int = 9,
                          mode: str = "sector") -> Tensor:
    """The same function in plain tensor ops, on any device."""
    B, ch, cw, gh = _geometry(gray, cell)
    fx, fy = gradients(gray[:, : gh + 2, : cw * cell + 2])
    mag, b = mag_bin_impl(mode)(fx, fy)
    geom = HOGConfig(window_h=gh + 2, window_w=cw * cell + 2, cell=cell,
                     bins=bins)
    return cell_histograms(mag, b, geom)


def dense_grad_hist(gray: Tensor, cell: int = 8, bins: int = 9,
                    mode: str = "sector") -> Tensor:
    """(B, H, W) f32 dense scene -> (B, ch, cw, bins) cell histograms,
    f32 or, for mode="fixed", int16."""
    code = mode_code(mode)
    if gray.dim() != 3 or gray.dtype != torch.float32:
        raise ValueError(f"dense_grad_hist takes (B, H, W) float32, got "
                         f"{tuple(gray.shape)} {gray.dtype}")
    B, ch, cw, _ = _geometry(gray, cell)
    if ch < 1 or cw < 1:
        raise ValueError(f"scene {tuple(gray.shape)} holds no whole cell")
    if gray.device.type == "cpu":
        return dense_grad_hist_plain(gray, cell, bins, mode)
    if gray.device.type != "cuda":
        raise ValueError(f"dense_grad_hist: unsupported device {gray.device}")
    if (cell, bins) != (8, 9):
        raise ValueError("the CUDA kernel is built for 8-px cells, 9 bins")
    if not gray.is_contiguous():
        raise ValueError("dense_grad_hist: gray must be contiguous")
    out = torch.empty((B, ch, cw, bins),
                      dtype=torch.int16 if mode == "fixed" else torch.float32,
                      device=gray.device)
    build.launch("dense_grad_hist", _ARGTYPES, gray, gray.data_ptr(),
                 out.data_ptr(), B, gray.shape[1], gray.shape[2], code)
    dense_grad_hist.launches += 1
    return out


dense_grad_hist.launches = 0
