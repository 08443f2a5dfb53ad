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

The dense kernel, bound on the H100: a 640x480 frame's three levels move
3.7 MB (1.1 us at 3.35 TB/s) and, in the fixed mode, do 77 M int32
operations (4.6 us at 64 INT32 lanes per SM per clock), each level one
launch. Its launch plan (``dense_plan``: tile, threads, grid, shared
memory) is computed here, once per level shape, and handed to the
launcher, which refuses a plan it was not compiled for. A CTA owns a
tile of 3x6, 3x4 or 2x4 blocks, chosen per level, and computes the
(TR+1) x (TC+1) cells they need, 16 threads a cell and 4 pixels a
thread (1.5-1.8x the cells of the level).

The window kernel, bound on the H100: bytes in the float modes -- a
window reads 34.3 KB and writes 15.1 KB, 7.6 us for B = 512 windows at
3.35 TB/s -- and the INT32 lanes in the fixed mode. Its launch plan
(``window_plan``) cuts each window into bands of K block rows
(``WINDOW_BANDS``: the whole window where the batch fills the card); a
CTA stages its band's gray rows by bulk copies, computes the K + 1 cell
rows they need in dense_fused_hog's order (16 threads a cell, 4 pixels a
thread) and stores its K x 7 blocks as float4, so ``fused_hog(g)`` is
``dense_fused_hog(g).reshape(B, -1)`` bit for bit.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (``dense_fused_hog_plain``, ``fused_hog_plain``) for a CPU
tensor; nothing else.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from ..core import numerics as N
from . import build
from .build import SMS
from .dense_block_norm import (dense_block_norm_plain,
                               norm_code)
from .dense_grad_hist import dense_grad_hist_plain
from .hog_gradient import BAR_BYTES, WINDOW_W, check_window_layout
from .mag_bin import mode_code
from .tile_plan import BandPlan, pick_band

Tensor = torch.Tensor

# the kernels' common arguments: gray, out, B, H, W, eps^2, mode, norm
_ARGTYPES = ((ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 3
             + (ctypes.c_float,) + (ctypes.c_int,) * 2)
# the window kernel's, then its plan's band, grid, threads and smem_bytes
_WINDOW_ARGTYPES = _ARGTYPES + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
# the dense kernel's, then its plan's grid_x, grid_y, tile_rows,
# tile_cols, threads and smem_bytes
_DENSE_ARGTYPES = _ARGTYPES + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)

#: the tiles the dense kernel is compiled for, block rows x block columns
#: a CTA owns (Tile<TR, TC> in csrc/dense_fused_hog.cu:pick, which refuses
#: others); dense_plan picks one per level
DENSE_TILES = ((3, 6), (3, 4), (2, 4))


def dense_threads(tile: Tuple[int, int]) -> int:
    """Threads of a CTA (Tile::THREADS): 16 for each of the (TR+1) x (TC+1)
    cells it may compute, 4 pixels each, in whole rows of 64."""
    return -(-16 * (tile[0] + 1) * (tile[1] + 1) // 64) * 64


def dense_min_ctas(tile: Tuple[int, int]) -> int:
    """CTAs an SM holds at least (Tile::MIN_CTAS, the kernel's launch
    bounds, which keep its registers to 48)."""
    n = dense_threads(tile)
    return 5 if n <= 256 else 4 if n <= 320 else 3


def dense_gray_pitch(tile: Tuple[int, int]) -> int:
    """Row pitch of a CTA's staged gray in floats (Tile::GP): the
    (TC+1)*8 + 2 columns, made odd against bank conflicts."""
    return ((tile[1] + 1) * 8 + 2) | 1


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """How ``dense_fused_hog`` covers one (B, H, W) level: CTA (tx, ty)
    owns blocks [ty*TR, ty*TR + TR) x [tx*TC, tx*TC + TC) (clipped to the
    grid) and computes the cells they need, those of the same indices and
    the row below and column to the right."""
    B: int
    ch: int
    cw: int
    tile: Tuple[int, int]           # (TR, TC) blocks a CTA owns
    grid: Tuple[int, int, int]      # (x, y, B) CTAs
    threads: int
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def blocks(self, tx: int, ty: int) -> Tuple[int, int, int, int]:
        """Blocks CTA (tx, ty) owns: rows [r0, r1) x columns [c0, c1)."""
        tr, tc = self.tile
        return (min(ty * tr, self.ch - 1), min(ty * tr + tr, self.ch - 1),
                min(tx * tc, self.cw - 1), min(tx * tc + tc, self.cw - 1))

    def cells(self, tx: int, ty: int) -> Tuple[int, int, int, int]:
        """Cells CTA (tx, ty) computes: rows [r0, r1) x columns [c0, c1),
        which its staged gray covers with rows 8 r0 .. 8 r1 + 1 and
        columns 8 c0 .. 8 c1 + 1."""
        tr, tc = self.tile
        return (min(ty * tr, self.ch), min(ty * tr + tr + 1, self.ch),
                min(tx * tc, self.cw), min(tx * tc + tc + 1, self.cw))

    def recompute(self) -> float:
        """Cells computed over cells needed (ch x cw per scene)."""
        done = 0
        for ty in range(self.grid[1]):
            for tx in range(self.grid[0]):
                r0, r1, c0, c1 = self.cells(tx, ty)
                done += max(0, r1 - r0) * max(0, c1 - c0)
        return done / (self.ch * self.cw)

    def resident_warps(self, blocks_per_sm: int, sms: int = SMS) -> float:
        """Warps per SM: the smaller of what an SM holds (``blocks_per_sm``,
        from cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the grid's
        CTAs per SM, times the warps of a CTA."""
        return min(blocks_per_sm, self.ctas / sms) * self.threads / 32


def dense_smem_bytes(mode: str, tile: Tuple[int, int]) -> int:
    """Shared memory of one CTA of csrc/dense_fused_hog.cu (its Smem):
    each block's 36 squares, the partial sums (per cell 8 rows of 9 f32
    bins; fixed, 9 int32; whole int4), the gray of (TR+1) x (TC+1) cells
    with the 1-px halo, 1/norm and max|v| per block, the cell histograms
    (int16 in the fixed mode)."""
    tr, tc = tile
    slots = (tr + 1) * (tc + 1)
    part = -(-slots * 9 * (1 if mode == "fixed" else 8) // 4) * 4
    gray = ((tr + 1) * 8 + 2) * dense_gray_pitch(tile)
    hist = (2 if mode == "fixed" else 4) * slots * 9
    size = 4 * (36 * tr * tc + part + gray + 2 * tr * tc) + hist
    return -(-size // 4) * 4


def _plan_for(tile: Tuple[int, int], B: int, H: int, W: int,
              mode: str = "sector") -> DensePlan:
    """The plan of a (B, H, W) gray of 8-px cells and 2x2 blocks at
    ``tile``, one of DENSE_TILES."""
    ch, cw = (H - 2) // 8, (W - 2) // 8
    if ch < 2 or cw < 2:
        raise ValueError(f"scene ({B}, {H}, {W}) holds no whole block")
    grid = (-(-(cw - 1) // tile[1]), -(-(ch - 1) // tile[0]), B)
    return DensePlan(B, ch, cw, tuple(tile), grid, dense_threads(tile),
                     dense_smem_bytes(mode, tile))


@functools.lru_cache(maxsize=None)
def dense_plan(B: int, H: int, W: int, mode: str = "sector",
               sms: int = SMS) -> DensePlan:
    """The launch plan of ``dense_fused_hog`` for a (B, H, W) gray on a
    card of ``sms`` SMs: the tile of DENSE_TILES that gives at least one
    CTA per SM and, with CTAs dealt round the SMs, the fewest cells on the
    busiest SM (the level's time, as every level of a frame runs in about
    one wave); a level too small for any takes the smallest tile."""
    plans = [_plan_for(t, B, H, W, mode) for t in DENSE_TILES]
    fit = [p for p in plans if p.ctas >= sms]
    if not fit:
        return min(plans, key=lambda p: p.tile[0] * p.tile[1])
    return min(fit, key=lambda p: -(-p.ctas // sms)
               * (p.tile[0] + 1) * (p.tile[1] + 1))


def dense_occupancy(plan: DensePlan, mode: str) -> int:
    """CTAs of the ``mode`` kernel one SM of the current card holds at
    the plan's threads and shared memory (the card's own count)."""
    blocks = ctypes.c_int(0)
    fn = build.library("dense_fused_hog").dense_fused_hog_occupancy
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    rc = fn(mode_code(mode), norm_code(_norm_flavor(mode)), *plan.tile,
            plan.threads, plan.smem_bytes, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"dense_fused_hog occupancy: cudaError {rc}")
    return blocks.value


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
    mode_code(mode)                    # an unknown mode raises first
    norm_code(_norm_flavor(mode))
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
    plan = dense_plan(B, H, W, mode, build.sm_count(gray.device.index))
    build.launch("dense_fused_hog", _DENSE_ARGTYPES, gray, gray.data_ptr(),
                 out.data_ptr(), B, H, W,
                 N.norm_eps_squared(eps, _norm_flavor(mode)), mode_code(mode),
                 norm_code(_norm_flavor(mode)), *plan.grid[:2], *plan.tile,
                 plan.threads, plan.smem_bytes)
    dense_fused_hog.launches += 1
    return out


dense_fused_hog.launches = 0


#: the bands the window kernel is compiled for, block rows of one window
#: a CTA owns (Band<K> in csrc/fused_hog.cu:pick, which refuses others);
#: window_plan picks one per batch
WINDOW_BANDS = (15, 8, 5, 3, 1)

#: threads of a window CTA: 16 cells of 16 threads a trip
WINDOW_THREADS = 256

#: each warp's partial sums in a window CTA (WPART): its 2 cells' 8 rows
#: of 9 bins
WINDOW_PART = 2 * 8 * 9


def window_smem_bytes(band: int) -> int:
    """Shared memory of one window CTA (Band::SMEM): the mbarriers, the
    gray of its K + 1 cell rows with the 1-px halo, the cells (9 bins
    padded to 12 floats), and each of its 8 warps' partial sums (whose
    space then holds 1/norm and the int8 step of each block)."""
    rows = 8 * (band + 1) + 2
    return BAR_BYTES + 4 * (rows * WINDOW_W + (band + 1) * 8 * 12
                            + WINDOW_THREADS // 32 * WINDOW_PART)


def window_plan_at(band: int, B: int, H: int) -> BandPlan:
    """The plan of B windows of H x 66 at ``band``, one of WINDOW_BANDS."""
    return BandPlan(B, (H - 2) // 8 - 1, 8, 8, band, WINDOW_THREADS,
                    window_smem_bytes(band))


@functools.lru_cache(maxsize=None)
def window_plan(B: int, H: int, W: int, mode: str = "sector",
                sms: int = SMS) -> BandPlan:
    """The launch plan of ``fused_hog`` for B windows of H x W on a card of
    ``sms`` SMs: of WINDOW_BANDS, the band that gives every SM a CTA and
    the fewest staged gray rows to the busiest SM (tile_plan.pick_band).
    CTA (band i, window b) owns block rows ``plan.owned(i)`` and computes
    their cell rows and the one below from gray rows ``plan.staged(i)``.
    Every mode gets the same plan (its cells are staged as f32)."""
    mode_code(mode)
    bh = (H - 2) // 8 - 1
    if W != WINDOW_W or H % 2 or bh < 1:
        raise ValueError(f"fused_hog: no plan for {B} windows of {H}x{W} "
                         f"(the kernel takes even heights of at least 2 "
                         f"cells, {WINDOW_W} columns)")
    return pick_band([window_plan_at(k, B, H) for k in WINDOW_BANDS], sms)


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
    mode_code(mode)
    norm_code(_norm_flavor(mode))
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
    check_window_layout(gray, "fused_hog")
    plan = window_plan(B, H, W, mode, build.sm_count(gray.device.index))
    if plan.smem_bytes > build.SMEM_DEFAULT:
        raise ValueError(f"fused_hog: band {plan.band} needs "
                         f"{plan.smem_bytes} B of shared memory, over "
                         f"{build.SMEM_DEFAULT}")
    return _window_launch(gray, eps, mode, plan)


def _window_launch(gray: Tensor, eps: float, mode: str,
                   plan: BandPlan) -> Tensor:
    B, H, W = gray.shape
    out = torch.empty((B, plan.units * 7 * 36), dtype=torch.float32,
                      device=gray.device)
    build.launch("fused_hog", _WINDOW_ARGTYPES, gray, gray.data_ptr(),
                 out.data_ptr(), B, H, W,
                 N.norm_eps_squared(eps, _norm_flavor(mode)), mode_code(mode),
                 norm_code(_norm_flavor(mode)), plan.band, plan.ctas,
                 plan.threads, plan.smem_bytes)
    fused_hog.launches += 1
    return out


fused_hog.launches = 0
