"""Window block L2 normalization (HOG stages 4-5, eq. 5): (B, ch, 8, 9)
f32 cell histograms -> (B, ch-1, 7, 36) f32 blocks; in the fixed flavor
int16 histograms -> f32 blocks on their per-block int8 grid.

Replaces the TPU kernel repro/kernels/block_norm.py:41 (``block_norm``),
CUDA source csrc/block_norm.cu.

Bound on the H100: bytes -- a window reads 4.6 KB and writes 15.1 KB,
35 us for B = 5,949 windows at 3.35 TB/s. A CTA owns a band of block
rows of one window across its full width (``BLOCK_NORM_BANDS``, chosen
per batch by ``block_norm_plan``): its cell rows are one contiguous span
in, its blocks one contiguous span out in float4 stores. Below one window
a SM the bands are short and run the dense kernel's tile body
(csrc/block_tile.cuh, 4 outputs a thread); from there a CTA takes a whole
window, one thread a block. Both keep finish_block's order, so
``block_norm(h)`` equals ``dense_block_norm(h)`` bit for bit.

``block_norm`` launches the kernel for a CUDA tensor and runs the plain
version ``block_norm_plain`` for a CPU tensor; nothing else.
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
from .dense_block_norm import (block_norm_smem_bytes, dense_block_norm_plain,
                               norm_code)
from .tile_plan import Resident, pick_band

Tensor = torch.Tensor

# hist, out, B, ch, cw, eps2, norm, then the plan's bands, rows, body,
# threads and smem_bytes, and the stream
_ARGTYPES = ((ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 3
             + (ctypes.c_float,) + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))

#: the cells across the window the kernel is compiled for (the paper's
#: 64-px active width, csrc/block_norm.cu:CW)
WINDOW_CW = 8
#: a staged cell's floats in the one-thread-a-block body (9 bins, 3
#: float4)
CELL_PITCH = 12

#: the bands the kernel is compiled for, (block rows of one window a CTA
#: owns across the full width, threads, body) (csrc/block_norm.cu:pick,
#: which refuses others). Body 0: the dense kernel's tile body, 4 outputs
#: a thread, for batches below one window a SM; body 1: a whole window a
#: CTA, one thread a block, from one window a SM up
SMALL_BANDS = ((1, 64, 0), (3, 128, 0))
WHOLE_WINDOW = (15, 128, 1)
BLOCK_NORM_BANDS = SMALL_BANDS + (WHOLE_WINDOW,)


def band_smem_bytes(rows: int, body: int) -> int:
    """Shared memory of one CTA: the tile body's (dense_block_norm's
    formula at the full-width tile), or the staged cells at CELL_PITCH and
    the band's blocks."""
    if body == 0:
        return block_norm_smem_bytes((rows, WINDOW_CW - 1))
    return 4 * ((rows + 1) * WINDOW_CW * CELL_PITCH
                + rows * (WINDOW_CW - 1) * 36)


@dataclasses.dataclass(frozen=True)
class BlockBandPlan(Resident):
    """How ``block_norm`` covers B windows of ``blocks`` block rows: CTA
    b * bands + i owns block rows ``owned(i)`` of window b across the full
    width and stages their cell rows and the one below."""
    B: int
    blocks: int                     # block rows of a window (ch - 1)
    rows: int                       # block rows a CTA owns
    body: int
    threads: int
    smem_bytes: int

    @property
    def tile(self) -> Tuple[int, int]:
        """The compiled shape a CTA takes (the occupancy entry point's
        arguments): rows and body."""
        return (self.rows, self.body)

    @property
    def bands(self) -> int:
        return -(-self.blocks // self.rows)

    @property
    def ctas(self) -> int:
        return self.B * self.bands

    def owned(self, i: int) -> Tuple[int, int]:
        """Block rows band ``i`` owns: [r0, r1)."""
        return (min(i * self.rows, self.blocks),
                min(i * self.rows + self.rows, self.blocks))

    def busiest_rows(self, sms: int = SMS) -> int:
        """Staged cell rows of the busiest SM, the CTAs dealt round
        ``sms`` SMs (tile_plan.pick_band's measure)."""
        return -(-self.ctas // sms) * (self.rows + 1)


def block_norm_plan_at(band: Tuple[int, int, int], B: int,
                       ch: int) -> BlockBandPlan:
    """The plan of B windows of ch x 8 cells at ``band``, one of
    BLOCK_NORM_BANDS."""
    rows, threads, body = band
    return BlockBandPlan(B, ch - 1, rows, body, threads,
                         band_smem_bytes(rows, body))


@functools.lru_cache(maxsize=None)
def block_norm_plan(B: int, ch: int, cw: int, mode: str = "rsqrt",
                    sms: int = SMS) -> BlockBandPlan:
    """The launch plan of ``block_norm`` for B windows of ch x cw cells on
    a card of ``sms`` SMs: from one window a SM up, a whole window a CTA
    (WHOLE_WINDOW); below, of SMALL_BANDS the band that gives every SM a
    CTA and the fewest staged cell rows to the busiest SM, then the fewest
    CTAs (tile_plan.pick_band), or, where none fills the card, the most
    CTAs. The same band in every flavor."""
    norm_code(mode)
    if cw != WINDOW_CW or ch < 2:
        raise ValueError(f"block_norm: no plan for {B} windows of {ch}x{cw} "
                         f"cells (the kernel takes {WINDOW_CW} across, at "
                         f"least 2 down)")
    if B >= sms:
        return block_norm_plan_at(WHOLE_WINDOW, B, ch)
    return pick_band([block_norm_plan_at(k, B, ch) for k in SMALL_BANDS], sms)


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
    if not hist.is_contiguous():
        raise ValueError("block_norm: hist must be contiguous")
    plan = block_norm_plan(B, ch, cw, mode, build.sm_count(hist.device.index))
    return _launch(hist, eps, mode, plan)


def _launch(hist: Tensor, eps: float, mode: str,
            plan: BlockBandPlan) -> Tensor:
    B, ch, cw, _ = hist.shape
    out = torch.empty((B, ch - 1, cw - 1, 36), dtype=torch.float32,
                      device=hist.device)
    build.launch("block_norm", _ARGTYPES, hist, hist.data_ptr(),
                 out.data_ptr(), B, ch, cw, N.norm_eps_squared(eps, mode),
                 norm_code(mode), plan.bands, plan.rows, plan.body,
                 plan.threads, plan.smem_bytes)
    block_norm.launches += 1
    return out


block_norm.launches = 0
