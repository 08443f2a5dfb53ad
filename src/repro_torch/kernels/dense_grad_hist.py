"""Dense gradient -> magnitude/bin -> cell histograms over a scene:
(B, H, W) f32 gray -> (B, ch, cw, 9), H = gh + 2 with gh whole cells; f32
histograms in the float modes, int16 in the fixed mode (integer-valued
gray in, int32 sums stored as int16).

Replaces the TPU kernel repro/kernels/dense_grad_hist.py:62
(``dense_grad_hist``), CUDA source csrc/dense_grad_hist.cu.

Bound on the H100: a 640x480 level moves 1.4 MB (under half a
microsecond at 3.35 TB/s), and the fixed mode's int32 CORDIC takes the
INT32 lanes about 2 us at the largest level, so one launch's overhead
weighs as much as the work. A CTA owns a tile of TR x TC cells (``GRAD_HIST_TILES``,
chosen per level by ``dense_grad_hist_plan``), stages its gray with the
1-px halo in shared memory, gives every cell 16 threads of 4 pixels and
stores each tile row of histograms in consecutive values.

``dense_grad_hist`` launches the kernel for a CUDA tensor and runs the
plain version ``dense_grad_hist_plain`` for a CPU tensor; nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..core.hog import HOGConfig, cell_histograms, gradients
from . import build
from .build import SMS
from .mag_bin import mag_bin_impl, mode_code
from .tile_plan import TilePlan, pick_plan, plan_at

Tensor = torch.Tensor

# gray, hist, B, H, W, mode, then the plan's grid_x, grid_y, tile_rows,
# tile_cols, threads and smem_bytes, and the stream
_ARGTYPES = ((ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 10
             + (ctypes.c_void_p,))

#: the tiles the kernel is compiled for, cell rows x cell columns a CTA
#: owns (Tile<TR, TC> in csrc/dense_grad_hist.cu:pick, which refuses
#: others); dense_grad_hist_plan picks one per level
GRAD_HIST_TILES = ((2, 4), (2, 8))


def grad_hist_threads(tile: Tuple[int, int]) -> int:
    """Threads of a CTA (Tile::THREADS): 16 a cell, 4 pixels each."""
    return 16 * tile[0] * tile[1]


def grad_hist_gray_pitch(tile: Tuple[int, int]) -> int:
    """Row pitch of a CTA's staged gray in floats (Tile::GP): the
    TC*8 + 2 columns, made odd against bank conflicts."""
    return (tile[1] * 8 + 2) | 1


def grad_hist_smem_bytes(mode: str, tile: Tuple[int, int]) -> int:
    """Shared memory of one CTA (csrc/dense_grad_hist.cu's Smem): the
    partial sums (per cell 8 rows of 9 f32 bins; fixed, 9 int32; whole
    int4), then the gray of TR x TC cells with the 1-px halo."""
    tr, tc = tile
    part = -(-tr * tc * 9 * (1 if mode == "fixed" else 8) // 4) * 4
    return 4 * (part + (tr * 8 + 2) * grad_hist_gray_pitch(tile))


@functools.lru_cache(maxsize=None)
def dense_grad_hist_plan(B: int, H: int, W: int, mode: str = "sector",
                         sms: int = SMS) -> TilePlan:
    """The launch plan of ``dense_grad_hist`` for a (B, H, W) gray on a
    card of ``sms`` SMs: of GRAD_HIST_TILES, the tile that gives every SM
    a CTA and the fewest cells to the busiest SM (tile_plan.pick_plan).
    CTA (tx, ty) computes the cells ``plan.units(tx, ty)``, from gray rows
    8 r0 .. 8 r1 + 1 and columns 8 c0 .. 8 c1 + 1."""
    ch, cw = (H - 2) // 8, (W - 2) // 8
    if ch < 1 or cw < 1:
        raise ValueError(f"scene ({B}, {H}, {W}) holds no whole cell")
    return pick_plan([plan_at(t, B, ch, cw, grad_hist_threads(t),
                              grad_hist_smem_bytes(mode, t))
                      for t in GRAD_HIST_TILES], sms)


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
    plan = dense_grad_hist_plan(B, gray.shape[1], gray.shape[2], mode,
                                build.sm_count(gray.device.index))
    build.launch("dense_grad_hist", _ARGTYPES, gray, gray.data_ptr(),
                 out.data_ptr(), B, gray.shape[1], gray.shape[2], code,
                 *plan.grid[:2], *plan.tile, plan.threads, plan.smem_bytes)
    dense_grad_hist.launches += 1
    return out


dense_grad_hist.launches = 0
