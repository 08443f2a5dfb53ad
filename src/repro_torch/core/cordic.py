"""CORDIC vectoring mode -- the port of repro/core/cordic.py.

Faithful to the paper's hardware unit (Fig. 7-8): 15 iterations, a
15-entry arctan lookup table, shift-add datapath. Vectoring mode drives
y -> 0 while accumulating the rotation angle in z; after n iterations
x ~= K * sqrt(x0^2 + y0^2) with gain K = prod_i sqrt(1 + 2^-2i), which is
divided back out.

Two halves: ``cordic_mag_angle`` in f32 (the float numerics), and
``cordic_mag_bin_fixed``, the int32 shift-add datapath of
``numerics="fixed"`` (the quant preset).
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


# ------------------------------------------------ fixed-point CORDIC

#: angle registers hold degrees in Q16 (repro/core/cordic.py:99-100)
ANG_FRAC_BITS = 16
ANG_180 = 180 << ANG_FRAC_BITS

#: Python's round of the f64 LUT in Q16 degrees (repro/core/cordic.py:102)
ATAN_LUT_FIXED = tuple(int(round(d * (1 << ANG_FRAC_BITS)))
                       for d in ATAN_LUT_DEG)

#: x/y registers hold gray-level units in Q8 (repro/core/cordic.py:108)
MAG_FRAC_BITS = 8

#: un-gain, un-Q8 and halve in one multiplier (repro/core/cordic.py:112):
#: an f64 Python constant that enters the reference as its f32 rounding
_INV_GAIN_HALF = 1.0 / (cordic_gain(MAX_ITERS) * (1 << MAG_FRAC_BITS) * 2)


def cordic_mag_bin_fixed(fx: torch.Tensor, fy: torch.Tensor,
                         iters: int = MAX_ITERS, bins: int = 9
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer shift-add CORDIC: integer-valued (fx, fy) -> (mag_q int32,
    bin int32), op for op as repro/core/cordic.py:cordic_mag_bin_fixed.

    int32 registers, arithmetic right shifts for the 2^-i rotations (torch
    ``>>`` on int32 is arithmetic), Q16-degree angle, the on-axis pin, the
    floor-mod fold (``torch.remainder``, as ``jnp.mod``) and the bin
    divide in integers. mag_q is the magnitude in half-gray-level units,
    rounded half to even (``torch.round``, as ``jnp.rint``).
    """
    xi = torch.round(fx).to(torch.int32)
    yi = torch.round(fy).to(torch.int32)
    neg_x = xi < 0
    x = torch.where(neg_x, -xi, xi) << MAG_FRAC_BITS
    y = torch.where(neg_x, -yi, yi) << MAG_FRAC_BITS
    z = torch.zeros_like(x)
    for i in range(iters):
        xs, ys = x >> i, y >> i
        d = y < 0
        lut = ATAN_LUT_FIXED[i]
        x, y, z = (torch.where(d, x - ys, x + ys),
                   torch.where(d, y + xs, y - xs),
                   torch.where(d, z - lut, z + lut))
    z = torch.where(yi == 0, 0, z)
    ang = torch.where(neg_x, torch.where(yi >= 0, z + ANG_180, z - ANG_180),
                      z)
    theta = torch.remainder(ang, ANG_180)               # [0, 180) in Q16
    b = torch.clamp(theta // (ANG_180 // bins), max=bins - 1)
    inv = torch.tensor(_INV_GAIN_HALF, dtype=torch.float32, device=x.device)
    mag_q = torch.round(x.to(torch.float32) * inv).to(torch.int32)
    both_zero = (xi == 0) & (yi == 0)
    return torch.where(both_zero, 0, mag_q), torch.where(both_zero, 0, b)
