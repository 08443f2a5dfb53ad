"""Dense 2x2-block L2 normalization (eq. 5) over a scene's cell grid:
(B, ch, cw, 9) f32 -> (B, ch-1, cw-1, 36) f32; in the fixed flavor
(B, ch, cw, 9) int16 -> f32 blocks on their per-block int8 grid.

Replaces the TPU kernel repro/kernels/dense_block_norm.py:41
(``dense_block_norm``), CUDA source csrc/dense_block_norm.cu.

Bound on the H100: memory, far below a launch at the detector's sizes
(0.8 MB at a 640x480 level, a quarter of a microsecond at 3.35 TB/s). A
CTA owns a tile of TR x TC blocks (``BLOCK_NORM_TILES``, chosen per level
by ``dense_block_norm_plan``), stages the (TR+1) x (TC+1) cells they need
in coalesced rows, sums each block's squares in the reference's order
(csrc/finish_blocks.cuh) and stores 4 values a thread as one float4.

``dense_block_norm`` launches the kernel for a CUDA tensor and runs the
plain version ``dense_block_norm_plain`` for a CPU tensor; nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..core import numerics as N
from ..core.hog import HOGConfig, gather_blocks
from . import build
from .build import SMS
from .tile_plan import TilePlan, pick_plan, plan_at

Tensor = torch.Tensor

#: norm flavor -> the value the CUDA launchers take (csrc/finish_blocks.cuh)
NORM_CODES = {"rsqrt": 0, "nr": 1, "fixed": 2}

# hist, out, B, ch, cw, eps2, norm, then the plan's grid_x, grid_y,
# tile_rows, tile_cols, threads and smem_bytes, and the stream
_ARGTYPES = ((ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 3
             + (ctypes.c_float,) + (ctypes.c_int,) * 7 + (ctypes.c_void_p,))

#: the tiles the kernel is compiled for, block rows x block columns a CTA
#: owns (Tile<TR, TC> in csrc/dense_block_norm.cu:pick, which refuses
#: others; the source says why one is enough)
BLOCK_NORM_TILES = ((2, 8),)


def norm_code(mode: str) -> int:
    """Validate a norm flavor and return its launcher code."""
    try:
        return NORM_CODES[mode]
    except KeyError:
        raise ValueError(f"unknown norm flavor {mode!r}; expected one of "
                         f"{sorted(NORM_CODES)}") from None


def block_norm_threads(tile: Tuple[int, int]) -> int:
    """Threads of a CTA (Tile::THREADS): one for each 4 of its blocks'
    values, in whole warps."""
    return -(-9 * tile[0] * tile[1] // 32) * 32


def block_norm_smem_bytes(tile: Tuple[int, int]) -> int:
    """Shared memory of one CTA (csrc/dense_block_norm.cu's Smem): each
    block's 36 squares, the (TR+1) x (TC+1) staged cells in f32, 1/norm
    and max|v| per block; the same in every flavor."""
    tr, tc = tile
    return 4 * (36 * tr * tc + (tr + 1) * (tc + 1) * 9 + 2 * tr * tc)


@functools.lru_cache(maxsize=None)
def dense_block_norm_plan(B: int, ch: int, cw: int, mode: str = "rsqrt",
                          sms: int = SMS) -> TilePlan:
    """The launch plan of ``dense_block_norm`` for a (B, ch, cw) cell grid
    on a card of ``sms`` SMs, by the rule of ``dense_grad_hist_plan``
    (tile_plan.pick_plan) over BLOCK_NORM_TILES, today one tile. CTA
    (tx, ty) makes the blocks ``plan.units(tx, ty)`` = [r0, r1) x
    [c0, c1) from the staged cells [r0, r1 + 1) x [c0, c1 + 1)."""
    norm_code(mode)
    if ch < 2 or cw < 2:
        raise ValueError(f"cell grid ({B}, {ch}, {cw}) holds no whole block")
    return pick_plan([plan_at(t, B, ch - 1, cw - 1, block_norm_threads(t),
                              block_norm_smem_bytes(t))
                      for t in BLOCK_NORM_TILES], sms)


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
    plan = dense_block_norm_plan(B, ch, cw, mode,
                                 build.sm_count(hist.device.index))
    build.launch("dense_block_norm", _ARGTYPES, hist, hist.data_ptr(),
                 out.data_ptr(), B, ch, cw, N.norm_eps_squared(eps, mode),
                 code, *plan.grid[:2], *plan.tile, plan.threads,
                 plan.smem_bytes)
    dense_block_norm.launches += 1
    return out


dense_block_norm.launches = 0
