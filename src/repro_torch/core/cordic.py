"""CORDIC vectoring mode, float half -- the port of repro/core/cordic.py.

Faithful to the paper's hardware unit (Fig. 7-8): 15 iterations, a
15-entry arctan lookup table, shift-add datapath. Vectoring mode drives
y -> 0 while accumulating the rotation angle in z; after n iterations
x ~= K * sqrt(x0^2 + y0^2) with gain K = prod_i sqrt(1 + 2^-2i), which is
divided back out.

The fixed-point half (int32 CORDIC of ``numerics="fixed"``) belongs to
the quant preset and is ported in slice 2.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

MAX_ITERS = 15

#: the hardware LUT: atan(2^-i) in degrees, i = 0..14
#: (repro/core/cordic.py:33)
ATAN_LUT_DEG = tuple(math.degrees(math.atan(2.0 ** -i))
                     for i in range(MAX_ITERS))


def cordic_gain(iters: int = MAX_ITERS) -> float:
    g = 1.0
    for i in range(iters):
        g *= math.sqrt(1.0 + 2.0 ** (-2 * i))
    return g


def cordic_mag_angle(x: torch.Tensor, y: torch.Tensor,
                     iters: int = MAX_ITERS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized CORDIC vectoring. Returns (magnitude, angle_degrees).

    Inputs in the left half-plane are pre-rotated by 180 deg (sign
    flip), then the iteration refines within (-90, 90); the angle covers
    (-180, 180].

    The shift factor is the exact power 2^-i. The reference computes it
    with ``jnp.exp2``, which XLA's CPU backend rounds one ulp low at
    i = 13; the effect is a last-bit wobble in the magnitude, never a
    different bin on the tests' inputs.
    """
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    neg_x = x < 0
    cx = torch.where(neg_x, -x, x)
    cy = torch.where(neg_x, -y, y)
    cz = torch.zeros_like(cx)
    lut = torch.tensor(ATAN_LUT_DEG[:iters], dtype=torch.float32,
                       device=x.device)
    for i in range(iters):
        p = 2.0 ** (-i)
        d = torch.where(cy < 0, -1.0, 1.0)
        cx, cy, cz = cx + d * cy * p, cy - d * cx * p, cz + d * lut[i]
    # on-axis inputs (y == 0) have an exact angle of 0 or 180; pin z so
    # the +-atan(2^-14) residual cannot leak through the unsigned fold
    cz = torch.where(y == 0, 0.0, cz)
    # divide by a device tensor, not a Python scalar: CUDA turns division
    # by a host scalar into a multiply by its reciprocal
    gain = torch.tensor(cordic_gain(iters), dtype=torch.float32,
                        device=x.device)
    mag = cx / gain
    ang = torch.where(neg_x, torch.where(y >= 0, cz + 180.0, cz - 180.0),
                      cz)
    both_zero = (x == 0) & (y == 0)
    return (torch.where(both_zero, 0.0, mag),
            torch.where(both_zero, 0.0, ang))
