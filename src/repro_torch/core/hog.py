"""HOG feature extraction in PyTorch -- the port of repro/core/hog.py.

Faithful to Nguyen et al. (2022): 130x66 window (1-px gradient border,
128x64 active), central-difference gradients (eqs. 1-2), magnitude and
unsigned orientation (eqs. 3-4), 8x8-pixel cells with 9 hard-assigned
bins, 2x2-cell blocks at 1-cell stride with L2 normalization (eq. 5),
15*7*36 = 3780 features.

Modes:
  * "ref"    -- sqrt + atan2 (the oracle; the staged pipeline routes it
               through the sector predicate, ``mag_bin_ref_fast``),
  * "cordic" -- 15-iteration CORDIC + Newton-Raphson rsqrt,
  * "sector" -- bin via 8 tangent-boundary cross-multiplication tests,
               hardware rsqrt,
  * "fixed"  -- ``numerics="fixed"``: the int32 shift-add CORDIC, int16
               cell histograms, NR rsqrt and per-block int8 blocks.

Plain tensor functions on any device; they are the plain path of the
"ref" backend and the building blocks of the kernels' plain versions.
``hog_descriptor`` runs the whole window chain on the "ref" stages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from . import numerics as N
from .cordic import cordic_mag_angle, cordic_mag_bin_fixed

Tensor = torch.Tensor

#: ITU-R BT.601 luma weights, Matlab's rgb2gray (repro/core/hog.py:41)
_LUMA = (0.2989, 0.5870, 0.1140)


@dataclasses.dataclass(frozen=True)
class HOGConfig:
    """Geometry of the paper's detection window (same fields and checks
    as repro/core/hog.py:44)."""

    window_h: int = 130
    window_w: int = 66
    cell: int = 8
    block: int = 2
    bins: int = 9
    eps: float = 1e-2
    mode: str = "ref"            # "ref" | "cordic" | "sector"
    feat_dtype: str = "f32"      # "f32" | "bf16" descriptor width
    numerics: str = "float"      # "float" | "fixed"

    def __post_init__(self):
        if self.numerics not in ("float", "fixed"):
            raise ValueError(
                f"numerics must be 'float' or 'fixed', got {self.numerics!r}")
        if self.numerics == "fixed" and self.feat_dtype != "f32":
            raise ValueError(
                "numerics='fixed' requires feat_dtype='f32' "
                f"(got {self.feat_dtype!r})")

    @property
    def active_h(self) -> int:   # 128
        return (self.window_h - 2) // self.cell * self.cell

    @property
    def active_w(self) -> int:   # 64
        return (self.window_w - 2) // self.cell * self.cell

    @property
    def cells_hw(self) -> Tuple[int, int]:      # (16, 8)
        return self.active_h // self.cell, self.active_w // self.cell

    @property
    def blocks_hw(self) -> Tuple[int, int]:     # (15, 7)
        ch, cw = self.cells_hw
        return ch - self.block + 1, cw - self.block + 1

    @property
    def block_dim(self) -> int:                 # 36
        return self.block * self.block * self.bins

    @property
    def n_features(self) -> int:                # 3780
        bh, bw = self.blocks_hw
        return bh * bw * self.block_dim


PAPER_HOG = HOGConfig()


def grayscale(rgb: Tensor) -> Tensor:
    """RGB (..., 3) uint8/float -> float32 gray in [0, 255]."""
    rgb = rgb.to(torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b


def grayscale_fused(rgb: Tensor) -> Tensor:
    """RGB (..., 3) -> float32 gray as the reference's jitted frame prep
    computes it (repro/core/detector.py:536 inside jax.jit), where XLA
    contracts ``grayscale``'s sum into two fused multiply-adds, each
    rounded once: fl(b * 0.114 + fl(r * 0.2989 + fl(g * 0.587))), the
    constants as f32.

    For uint8 input f64 evaluates each multiply-add exactly, so its one
    cast to f32 is the FMA's one rounding: a product of an integer <= 255
    (8 bits) and an f32 constant (24 bits) needs at most 32 bits, and
    each sum, of values under 256 whose lowest bits lie no lower than
    2^-27 (the ulp of f32(0.114)), at most 35 -- under f64's 53. Float
    input has no such bound (a product of two f32 values needs 48 bits,
    its sum with an f32 more than 53), so it keeps ``grayscale``'s eager
    order."""
    if rgb.dtype != torch.uint8:
        return grayscale(rgb)
    x = rgb.to(torch.float64)
    c = [torch.tensor(v, dtype=torch.float32).item() for v in _LUMA]
    t = (x[..., 1] * c[1]).to(torch.float32).to(torch.float64)
    t = (x[..., 0] * c[0] + t).to(torch.float32).to(torch.float64)
    return (x[..., 2] * c[2] + t).to(torch.float32)


def gradients(gray: Tensor) -> Tuple[Tensor, Tensor]:
    """Central differences. gray: (..., H, W) -> fx, fy on (..., H-2, W-2).

    eq. (1): f_x(x,y) = f(x+1,y) - f(x-1,y)   (along W)
    eq. (2): f_y(x,y) = f(x,y+1) - f(x,y-1)   (along H)
    """
    fx = gray[..., 1:-1, 2:] - gray[..., 1:-1, :-2]
    fy = gray[..., 2:, 1:-1] - gray[..., :-2, 1:-1]
    return fx, fy


_BOUNDARY_DEG = [20.0 * (k + 1) for k in range(8)]          # 20..160
#: boundary cos/sin as f64 Python floats, rounded to f32 where used
#: (repro/core/hog.py:131-133)
_COS_B = tuple(math.cos(math.radians(b)) for b in _BOUNDARY_DEG)
_SIN_B = tuple(math.sin(math.radians(b)) for b in _BOUNDARY_DEG)


def sqrt_rn(x: Tensor) -> Tensor:
    """Correctly rounded f32 sqrt, as XLA's and CUDA's sqrt are. PyTorch's
    vectorized CPU sqrt is up to 1 ulp off; the f64 sqrt of an f32 value
    rounded back to f32 is exact (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _bin_of(theta: Tensor, bins: int) -> Tensor:
    # floor-mod into [0, 180) (jnp.mod and torch.remainder are both
    # floor-mod), then the bin index; the divisor is a device tensor so
    # CUDA does not swap the division for a reciprocal multiply
    theta = torch.remainder(theta, 180.0)
    width = torch.tensor(180.0 / bins, dtype=torch.float32,
                         device=theta.device)
    b = torch.clamp(torch.floor(theta / width), 0, bins - 1)
    return b.to(torch.int32)


def mag_bin_ref(fx: Tensor, fy: Tensor, bins: int = 9
                ) -> Tuple[Tensor, Tensor]:
    """Oracle: sqrt + atan2, unsigned angle folded to [0, 180)."""
    mag = sqrt_rn(fx * fx + fy * fy)
    theta = torch.rad2deg(torch.atan2(fy, fx))
    return mag, _bin_of(theta, bins)


def mag_bin_cordic(fx: Tensor, fy: Tensor, bins: int = 9,
                   iters: int = 15) -> Tuple[Tensor, Tensor]:
    """Faithful mode: the paper's CORDIC (15 LUT angles, Fig. 7-8)."""
    mag, theta_deg = cordic_mag_angle(fx, fy, iters=iters)
    return mag, _bin_of(theta_deg, bins)


def mag_bin_sector(fx: Tensor, fy: Tensor, bins: int = 9
                   ) -> Tuple[Tensor, Tensor]:
    """Bin via cross-multiplication against tan boundaries.

    Fold the direction to the upper half-plane, then theta >= b_k  <=>
    fy*cos(b_k) - fx*sin(b_k) >= 0. bin = number of boundaries passed.
    """
    if bins != 9:
        raise ValueError("sector table is built for 9 bins")
    mag = sqrt_rn(fx * fx + fy * fy)
    flip = fy < 0
    ux = torch.where(flip, -fx, fx)
    uy = torch.where(flip, -fy, fy)
    # fy == 0, fx < 0 => theta == 180, which folds to bin 0
    on_axis = (uy == 0) & (ux < 0)
    ux = torch.where(on_axis, -ux, ux)
    cos_b = torch.tensor(_COS_B, dtype=torch.float32, device=fx.device)
    sin_b = torch.tensor(_SIN_B, dtype=torch.float32, device=fx.device)
    crossed = (uy[..., None] * cos_b - ux[..., None] * sin_b) >= 0.0
    return mag, torch.sum(crossed, dim=-1).to(torch.int32)


def mag_bin_ref_fast(fx: Tensor, fy: Tensor, bins: int = 9
                     ) -> Tuple[Tensor, Tensor]:
    """Hot-path form of ``mag_bin_ref``: the same sqrt magnitude, bins
    from the sector predicate (the same fp32 test reordered; differs
    only within float rounding of a 20-degree boundary)."""
    if bins != 9:
        return mag_bin_ref(fx, fy, bins)
    return mag_bin_sector(fx, fy, bins)


def mag_bin_fixed(fx: Tensor, fy: Tensor, bins: int = 9
                  ) -> Tuple[Tensor, Tensor]:
    """Fixed-point mode: the integer shift-add CORDIC (core/cordic.py).
    Returns int32 magnitudes in half-gray-level units (quant.MAG_SCALE)
    and int32 bins; the cell histograms accumulate them in int32 and
    store int16 (numerics.store_hist)."""
    return cordic_mag_bin_fixed(fx, fy, bins=bins)


_MAG_BIN = {"ref": mag_bin_ref, "cordic": mag_bin_cordic,
            "sector": mag_bin_sector, "fixed": mag_bin_fixed}

#: what the staged pipeline dispatches on: "ref" takes the sector path
_MAG_BIN_FAST = dict(_MAG_BIN, ref=mag_bin_ref_fast)


def cell_histograms(mag: Tensor, bin_idx: Tensor, cfg: HOGConfig) -> Tensor:
    """(..., Ha, Wa) mag/bin -> (..., ch, cw, bins) histograms.

    hist[c, b] = sum of the magnitudes of the pixels in cell c whose bin
    is b, as a select-and-reduce over the static bin count. Integer
    magnitudes accumulate in their own int32 (torch.sum would widen to
    int64) and store int16: 64 px * 361 = 23104 < 2^15 per cell.
    """
    ch, cw = cfg.cells_hw
    c = cfg.cell
    lead = mag.shape[:-2]
    m = mag.reshape(lead + (ch, c, cw, c))
    bi = bin_idx.reshape(lead + (ch, c, cw, c))
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    outs = [torch.sum(torch.where(bi == k, m, zero), dim=(-3, -1),
                      dtype=m.dtype)
            for k in range(cfg.bins)]
    return N.store_hist(torch.stack(outs, dim=-1))


def gather_blocks(hist: Tensor, cfg: HOGConfig) -> Tensor:
    """(..., ch, cw, bins) -> (..., bh, bw, block^2*bins) raw block
    vectors, cells in the order (0,0), (0,1), (1,0), (1,1)."""
    ch, cw = hist.shape[-3], hist.shape[-2]
    b = cfg.block
    bh, bw = ch - b + 1, cw - b + 1
    parts = [hist[..., i:i + bh, j:j + bw, :]
             for i in range(b) for j in range(b)]
    return torch.cat(parts, dim=-1)


def block_normalize(hist: Tensor, cfg: HOGConfig, use_nr: bool = False,
                    norm: str | None = None) -> Tensor:
    """(..., ch, cw, bins) -> (..., bh, bw, block_dim) L2-normalized
    blocks (eq. 5); the tail is ``numerics.finish_blocks``."""
    if norm is None:
        norm = "nr" if use_nr else "rsqrt"
    out = N.finish_blocks(gather_blocks(hist, cfg), cfg.eps, norm)
    if cfg.feat_dtype == "bf16":
        out = out.to(torch.bfloat16)
    return out


def collate(blocks: Tensor, cfg: HOGConfig) -> Tensor:
    """(..., bh, bw, 36) -> (..., 3780) descriptor."""
    return blocks.reshape(blocks.shape[:-3] + (cfg.n_features,))


def hog_descriptor(window: Tensor, cfg: HOGConfig = PAPER_HOG) -> Tensor:
    """Full HOG chain: (..., H, W, 3) RGB or (..., H, W) gray ->
    (..., n_features), on the plain "ref" stages. Windows larger than
    (cfg.window_h, cfg.window_w) are top-left-anchored and cropped;
    smaller ones raise ValueError. The chain is core/stages.py's."""
    from .stages import window_descriptor
    return window_descriptor(window, cfg, backend="ref")


def hog_descriptor_batch(windows: Tensor,
                         cfg: HOGConfig = PAPER_HOG) -> Tensor:
    """Batch-first alias: (B, H, W[, 3]) -> (B, n_features)."""
    return hog_descriptor(windows, cfg)
