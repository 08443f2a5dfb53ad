"""Window gradient -> magnitude and orientation bin (HOG stage 3):
(B, H, W) f32 gray windows -> (mag, bin), each (B, H-2, W-2); mag is f32
in the float modes and int32 half-gray units in the fixed mode (on
integer-valued gray), bin is int32.

Replaces the TPU kernel repro/kernels/hog_gradient.py:139
(``hog_gradient``), CUDA source csrc/hog_gradient.cu.

Bound on the H100: bytes in the float modes -- a 130x66 window reads
34.3 KB and writes 65.5 KB, 15.3 us for B = 512 windows at 3.35 TB/s --
and the INT32 lanes in the fixed mode. A CTA owns a band of R output rows
of one window (``GRADIENT_BANDS``, chosen per batch by
``hog_gradient_plan``), stages the band's gray rows (one contiguous,
16-byte aligned span) by bulk copies, a chunk per trip of 16 rows (a
band of one trip reads device memory directly), and gives each thread 4
consecutive columns of one row: 4 independent chains of the mode's device
function (csrc/mag_bin.cuh), stored as one float4 (int4) of mag and one
int4 of bin.

``hog_gradient`` launches the kernel for a CUDA tensor and runs the
plain version ``hog_gradient_plain`` for a CPU tensor; nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..core.hog import gradients
from . import build
from .build import SMS
from .mag_bin import mag_bin_impl, mode_code
from .tile_plan import BandPlan, pick_band

Tensor = torch.Tensor

# gray, mag, bin, B, H, W, mode, then the plan's band, grid, threads and
# smem_bytes, and the stream
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 8
             + (ctypes.c_void_p,))

#: the bands the kernel is compiled for, output rows of one window a CTA
#: owns (Band<R> in csrc/hog_gradient.cu:pick, which refuses others);
#: hog_gradient_plan picks one per batch
GRADIENT_BANDS = (128, 64, 32, 16, 8)

#: the window width the kernels are compiled for: 64 output columns, 16
#: threads of 4 (the paper's 130x66 window)
WINDOW_W = 66


def gradient_threads(band: int) -> int:
    """Threads of a CTA (Band::THREADS): 16 a row of 64, at most 256."""
    return min(256, 16 * band)


#: bytes of mbarriers a window CTA reserves, one per staging chunk
#: (csrc/window_stage.cuh:kBarBytes)
BAR_BYTES = 64


def gradient_staged(band: int) -> bool:
    """Whether a CTA stages its rows in shared memory (Band::STAGED): a
    band of more than one trip of 16 rows does; one of a single trip
    reads its rows straight from device memory."""
    return band * 16 // gradient_threads(band) > 1


def gradient_smem_bytes(band: int) -> int:
    """Shared memory of one CTA (Band::SMEM): the mbarriers, then the
    band's R + 2 gray rows of 66 floats; none for an unstaged band."""
    return (BAR_BYTES + 4 * (band + 2) * WINDOW_W if gradient_staged(band)
            else 0)


def check_window_layout(gray: Tensor, name: str) -> None:
    """Raise ValueError unless ``gray`` is a layout the window kernels
    take: contiguous (B, H, 66) with H even (so every window, and every
    band's span of gray rows, starts and ends 16-byte aligned) and a
    16-byte aligned first element."""
    B, H, W = gray.shape
    if W != WINDOW_W or H % 2:
        raise ValueError(f"{name}: the CUDA kernel is built for windows of "
                         f"even height and {WINDOW_W} columns, got {H}x{W}")
    if not gray.is_contiguous():
        raise ValueError(f"{name}: gray must be contiguous")
    if gray.data_ptr() % 16:
        raise ValueError(f"{name}: gray must start 16-byte aligned (a "
                         f"window's rows are staged in 16-byte copies)")


def gradient_plan_at(band: int, B: int, H: int) -> BandPlan:
    """The plan of B windows of H x 66 at ``band``, one of GRADIENT_BANDS."""
    return BandPlan(B, H - 2, 1, 0, band, gradient_threads(band),
                    gradient_smem_bytes(band))


@functools.lru_cache(maxsize=None)
def hog_gradient_plan(B: int, H: int, W: int, sms: int = SMS) -> BandPlan:
    """The launch plan of ``hog_gradient`` for B windows of H x W on a card
    of ``sms`` SMs: of GRADIENT_BANDS, the band that gives every SM a CTA
    and the fewest staged gray rows to the busiest SM
    (tile_plan.pick_band). CTA (band i, window b) computes output rows
    ``plan.owned(i)`` from gray rows ``plan.staged(i)``."""
    if W != WINDOW_W or H % 2 or H < 4:
        raise ValueError(f"hog_gradient: no plan for {B} windows of {H}x{W} "
                         f"(the kernel takes even heights, {WINDOW_W} "
                         f"columns)")
    return pick_band([gradient_plan_at(r, B, H) for r in GRADIENT_BANDS],
                     sms)


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
    mode_code(mode)                    # an unknown mode raises first
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
    check_window_layout(gray, "hog_gradient")
    plan = hog_gradient_plan(B, H, W, build.sm_count(gray.device.index))
    return _launch(gray, mode, plan)


def _launch(gray: Tensor, mode: str, plan: BandPlan) -> Tuple[Tensor, Tensor]:
    B, H, W = gray.shape
    mag = torch.empty((B, H - 2, W - 2), dtype=mag_dtype(mode),
                      device=gray.device)
    bins = torch.empty((B, H - 2, W - 2), dtype=torch.int32,
                       device=gray.device)
    build.launch("hog_gradient", _ARGTYPES, gray, gray.data_ptr(),
                 mag.data_ptr(), bins.data_ptr(), B, H, W, mode_code(mode),
                 plan.band, plan.ctas, plan.threads, plan.smem_bytes)
    hog_gradient.launches += 1
    return mag, bins


hog_gradient.launches = 0
