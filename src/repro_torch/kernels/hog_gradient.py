"""Window gradient -> magnitude and orientation bin (HOG stage 3):
(B, H, W) f32 gray windows -> (mag, bin), each (B, H-2, W-2); mag is f32
in the float modes and int32 half-gray units in the fixed mode (on
integer-valued gray), bin is int32.

Replaces the TPU kernel repro/kernels/hog_gradient.py:139
(``hog_gradient``), CUDA source csrc/hog_gradient.cu.

Bound on the H100: bytes -- a 130x66 window reads 34.3 KB and writes
65.5 KB, 177 us for B = 5,949 windows at 3.35 TB/s. One thread per
output pixel over (window, row, column), column fastest, so a warp's
reads and writes are consecutive; each pixel runs the mode's shared
device function (csrc/mag_bin.cuh).

``hog_gradient`` launches the kernel for a CUDA tensor and runs the
plain version ``hog_gradient_plain`` for a CPU tensor; nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.hog import gradients
from . import build
from .mag_bin import mag_bin_impl, mode_code

Tensor = torch.Tensor

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def mag_dtype(mode: str) -> torch.dtype:
    """The magnitude dtype a mode produces: int32 for the fixed chain."""
    mode_code(mode)
    return torch.int32 if mode == "fixed" else torch.float32


def hog_gradient_plain(gray: Tensor, mode: str = "sector"
                       ) -> Tuple[Tensor, Tensor]:
    """The same function in plain tensor ops, on any device."""
    fx, fy = gradients(gray)
    return mag_bin_impl(mode)(fx, fy)


def hog_gradient(gray: Tensor, mode: str = "sector") -> Tuple[Tensor, Tensor]:
    """(B, H, W) f32 windows -> (mag, bin), each (B, H-2, W-2)."""
    code = mode_code(mode)
    if gray.dim() != 3 or gray.dtype != torch.float32:
        raise ValueError(f"hog_gradient takes (B, H, W) float32, got "
                         f"{tuple(gray.shape)} {gray.dtype}")
    B, H, W = gray.shape
    if H < 3 or W < 3:
        raise ValueError(f"window {tuple(gray.shape)} has no interior pixel")
    if gray.device.type == "cpu":
        return hog_gradient_plain(gray, mode)
    if gray.device.type != "cuda":
        raise ValueError(f"hog_gradient: unsupported device {gray.device}")
    if not gray.is_contiguous():
        raise ValueError("hog_gradient: gray must be contiguous")
    mag = torch.empty((B, H - 2, W - 2), dtype=mag_dtype(mode),
                      device=gray.device)
    bins = torch.empty((B, H - 2, W - 2), dtype=torch.int32,
                       device=gray.device)
    build.launch("hog_gradient", _ARGTYPES, gray, gray.data_ptr(),
                 mag.data_ptr(), bins.data_ptr(), B, H, W, code)
    hog_gradient.launches += 1
    return mag, bins


hog_gradient.launches = 0
