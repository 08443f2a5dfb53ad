"""Launch plans of the tiled dense kernels that own disjoint tiles of a
(B, rows, cols) grid of units: ``dense_grad_hist`` (units are cells) and
``dense_block_norm`` (units are blocks). CTA (tx, ty, b) owns units
[ty*TR, ty*TR + TR) x [tx*TC, tx*TC + TC) of scene b, clipped to the grid.

``pick_plan`` takes, from a kernel's compiled tiles, the one that gives
every SM a CTA and, with the CTAs dealt round the SMs, the fewest units
to the busiest SM; between equals, the one with fewer CTAs. The
launchers in csrc/ take the plan's grid, tile, threads and shared memory
and refuse a plan they were not compiled for.

The window kernels (``hog_gradient``, ``fused_hog``) cut each window into
bands instead (``BandPlan``): CTA (band, b) owns units [band*R, band*R +
R) of window b, output rows or block rows, and stages the contiguous
span of gray rows they need. ``pick_band`` takes, from a kernel's
compiled bands, the one that gives every SM a CTA and the fewest staged
gray rows to the busiest SM; between equals, the one with fewer CTAs.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

from . import build
from .build import SMS


class Resident:
    """Occupancy of a launch plan that has ``ctas`` and ``threads``."""

    def resident_warps(self, blocks_per_sm: int, sms: int = SMS) -> float:
        """Warps per SM: the smaller of what an SM holds (``blocks_per_sm``,
        from cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the grid's
        CTAs per SM, times the warps of a CTA."""
        return min(blocks_per_sm, self.ctas / sms) * self.threads / 32


@dataclasses.dataclass(frozen=True)
class TilePlan(Resident):
    """How a tiled kernel covers one (B, rows, cols) grid of units."""
    B: int
    rows: int
    cols: int
    tile: Tuple[int, int]           # (TR, TC) units a CTA owns
    grid: Tuple[int, int, int]      # (x, y, B) CTAs
    threads: int
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def units(self, tx: int, ty: int) -> Tuple[int, int, int, int]:
        """Units CTA (tx, ty) owns: rows [r0, r1) x columns [c0, c1)."""
        tr, tc = self.tile
        return (min(ty * tr, self.rows), min(ty * tr + tr, self.rows),
                min(tx * tc, self.cols), min(tx * tc + tc, self.cols))

    def busiest_units(self, sms: int = SMS) -> int:
        """Units of the busiest SM, the CTAs dealt round ``sms`` SMs."""
        return -(-self.ctas // sms) * self.tile[0] * self.tile[1]


def plan_at(tile: Tuple[int, int], B: int, rows: int, cols: int,
            threads: int, smem_bytes: int) -> TilePlan:
    """The plan of a (B, rows, cols) grid of units at ``tile``."""
    grid = (-(-cols // tile[1]), -(-rows // tile[0]), B)
    return TilePlan(B, rows, cols, tuple(tile), grid, threads, smem_bytes)


def pick_plan(plans: Sequence[TilePlan], sms: int = SMS) -> TilePlan:
    """The plan with at least ``sms`` CTAs and the fewest units on the
    busiest SM, then the fewest CTAs; where none has ``sms`` CTAs, the
    one with the most."""
    fit = [p for p in plans if p.ctas >= sms]
    if not fit:
        return max(plans, key=lambda p: p.ctas)
    return min(fit, key=lambda p: (p.busiest_units(sms), p.ctas))


@dataclasses.dataclass(frozen=True)
class BandPlan(Resident):
    """How a window kernel covers a batch of B windows, each ``units``
    units (output rows, or block rows) of ``unit_rows`` gradient rows:
    CTA (band, b) owns units [band*R, band*R + R) of window b, clipped,
    computes the gradient rows of those units and ``seam`` rows more (the
    cell row below a band of blocks), and stages (or, a band of one trip,
    reads) their gray rows with the gradient's 1-px halo, one contiguous
    span."""
    B: int
    units: int
    unit_rows: int
    seam: int
    band: int                       # R units a CTA owns
    threads: int
    smem_bytes: int

    @property
    def tile(self) -> Tuple[int]:
        """The compiled shape a CTA takes: its band (the launch and
        occupancy entry points' argument)."""
        return (self.band,)

    @property
    def bands(self) -> int:
        return -(-self.units // self.band)

    @property
    def ctas(self) -> int:
        return self.B * self.bands

    def owned(self, i: int) -> Tuple[int, int]:
        """Units band ``i`` owns: [u0, u1)."""
        return (min(i * self.band, self.units),
                min(i * self.band + self.band, self.units))

    def staged(self, i: int) -> Tuple[int, int]:
        """Gray rows band ``i`` stages: [g0, g1)."""
        u0, u1 = self.owned(i)
        return u0 * self.unit_rows, u1 * self.unit_rows + self.seam + 2

    def busiest_rows(self, sms: int = SMS) -> int:
        """Staged gray rows of the busiest SM, the CTAs of full bands
        dealt round ``sms`` SMs."""
        return -(-self.ctas // sms) * (self.band * self.unit_rows
                                       + self.seam + 2)

    def recompute(self) -> float:
        """Gradient rows computed over the rows a window needs (1 where
        bands share no seam)."""
        done = sum(g1 - g0 - 2 for g0, g1 in map(self.staged,
                                                 range(self.bands)))
        return done / (self.units * self.unit_rows + self.seam)


def pick_band(plans: Sequence[BandPlan], sms: int = SMS) -> BandPlan:
    """The plan with at least ``sms`` CTAs and the fewest staged gray rows
    on the busiest SM, then the fewest CTAs; where none has ``sms`` CTAs,
    the one with the most."""
    fit = [p for p in plans if p.ctas >= sms]
    if not fit:
        return max(plans, key=lambda p: p.ctas)
    return min(fit, key=lambda p: (p.busiest_rows(sms), p.ctas))


def occupancy(name: str, code: int, plan) -> int:
    """CTAs of kernel ``name`` in the mode or flavor ``code`` that one SM
    of the current card holds at the plan's tile (a TilePlan's two sides,
    a BandPlan's band), threads and shared memory (the C entry point
    ``<name>_occupancy``)."""
    blocks = ctypes.c_int(0)
    fn = getattr(build.library(name), f"{name}_occupancy")
    fn.argtypes = ([ctypes.c_int] * (3 + len(plan.tile))
                   + [ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    rc = fn(code, *plan.tile, plan.threads, plan.smem_bytes,
            ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{name} occupancy: cudaError {rc}")
    return blocks.value
