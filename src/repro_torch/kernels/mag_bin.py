"""Plain PyTorch twins of the kernels' per-pixel magnitude/bin device
functions (csrc/mag_bin.cuh), which replace the Pallas device functions
repro/kernels/hog_gradient.py:38 (_mag_bin_sector), :51
(_mag_bin_cordic) and :76 (_mag_bin_fixed).

They differ from core/hog.py's modes only where the TPU kernels do: the
kernel CORDIC multiplies by 1/gain where core/cordic.py divides by the
gain. The fixed twin is core/hog.py's: _mag_bin_fixed is
core/cordic.py:cordic_mag_bin_fixed unrolled, the same integer ops.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import torch

from ..core.cordic import ATAN_LUT_DEG, cordic_gain
from ..core.hog import mag_bin_fixed, mag_bin_sector

Tensor = torch.Tensor

#: kernel mode -> the value the CUDA launchers take (csrc/mag_bin.cuh)
MODE_CODES = {"sector": 0, "cordic": 1, "fixed": 2}


def mag_bin_cordic(fx: Tensor, fy: Tensor,
                   iters: int = 15) -> Tuple[Tensor, Tensor]:
    """15 LUT-driven shift-add rotations, magnitude times 1/gain, the
    on-axis pin, then the unsigned fold and a floor divide by 20."""
    neg_x = fx < 0
    x = torch.where(neg_x, -fx, fx)
    y = torch.where(neg_x, -fy, fy)
    z = torch.zeros_like(fx)
    for i in range(iters):
        p = 2.0 ** (-i)
        d = torch.where(y < 0, -1.0, 1.0)
        x, y, z = x + d * y * p, y - d * x * p, z + d * ATAN_LUT_DEG[i]
    mag = x * (1.0 / cordic_gain(iters))
    z = torch.where(fy == 0, 0.0, z)
    ang = torch.where(neg_x, torch.where(fy >= 0, z + 180.0, z - 180.0), z)
    both_zero = (fx == 0) & (fy == 0)
    mag = torch.where(both_zero, 0.0, mag)
    ang = torch.where(both_zero, 0.0, ang)
    theta = torch.remainder(ang, 180.0)
    # a device-tensor divisor: CUDA turns division by a host scalar into
    # a reciprocal multiply, which the kernel's __fdiv_rn does not do
    twenty = torch.tensor(20.0, dtype=torch.float32, device=fx.device)
    b = torch.clamp(torch.floor(theta / twenty), 0, 8)
    return mag, b.to(torch.int32)


# the sector and fixed twins are core/hog.py's, which the kernel's
# arithmetic matches
MAG_BIN_IMPLS = {"sector": partial(mag_bin_sector, bins=9),
                 "cordic": mag_bin_cordic,
                 "fixed": partial(mag_bin_fixed, bins=9)}


def mag_bin_impl(mode: str):
    try:
        return MAG_BIN_IMPLS[mode]
    except KeyError:
        raise ValueError(
            f"unknown kernel numerics mode {mode!r}; expected one of "
            f"{sorted(MAG_BIN_IMPLS)}") from None


def mode_code(mode: str) -> int:
    """Validate a kernel mode and return its launcher code."""
    mag_bin_impl(mode)
    return MODE_CODES[mode]
