"""The numerics-mode table every backend dispatches on -- the port of
repro/core/numerics.py.

One place maps a mode name to its per-stage choices, so a mode cannot
normalize one way in the plain path and another in a kernel:

  * ``spec_for(cfg)``                 -- HOGConfig -> NumericsSpec,
  * ``store_hist(hist)``              -- accumulator -> stored dtype,
  * ``finish_blocks(v, eps, norm)``   -- the block-normalize tail, used
    by the plain path and mirrored op for op by the CUDA block-norm
    kernels (csrc/finish_blocks.cuh); ``norm="fixed"`` ends in the
    per-block int8 quantize-dequantize (core/quant.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from . import quant


@dataclasses.dataclass(frozen=True)
class NumericsSpec:
    """One numerics mode's per-stage choices.

    name        -- the mag/bin implementation key (core/hog.py _MAG_BIN),
    kernel_mode -- what the gradient/histogram kernels receive,
    norm        -- block-normalize tail flavor ("rsqrt" | "nr" | "fixed"),
    quantized   -- True iff the chain runs the fixed-point datapath.
    """

    name: str
    kernel_mode: str
    norm: str
    quantized: bool


#: a copy of repro/core/numerics.py:62
SPECS: Dict[str, NumericsSpec] = {
    "ref": NumericsSpec("ref", "sector", "rsqrt", False),
    "sector": NumericsSpec("sector", "sector", "rsqrt", False),
    "cordic": NumericsSpec("cordic", "cordic", "nr", False),
    "fixed": NumericsSpec("fixed", "fixed", "fixed", True),
}


def spec_for(cfg) -> NumericsSpec:
    """HOGConfig -> NumericsSpec. ``numerics="fixed"`` overrides ``mode``."""
    name = "fixed" if getattr(cfg, "numerics", "float") == "fixed" \
        else cfg.mode
    try:
        return SPECS[name]
    except KeyError:
        raise ValueError(
            f"unknown numerics mode {name!r}; expected one of "
            f"{sorted(SPECS)}") from None


def nr_rsqrt(x: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Newton-Raphson reciprocal sqrt, faithful to the hardware unit.

    Seed = the exponent-halving bit manipulation (0x5F3759DF), then
    ``iters`` NR steps with the reference's multiply order
    (repro/core/numerics.py:91): y * (1.5 - ((0.5 * x) * y) * y).
    """
    xf = x.to(torch.float32)
    i = xf.view(torch.int32)
    y = (0x5F3759DF - (i >> 1)).view(torch.float32)
    for _ in range(iters):
        y = y * (1.5 - 0.5 * xf * y * y)
    return y


#: which rsqrt each norm flavor uses; "fixed" shares the hardware NR
#: unit and then quantizes (repro/core/numerics.py:95)
NORM_RSQRT = {
    "rsqrt": torch.rsqrt,
    "nr": nr_rsqrt,
    "fixed": nr_rsqrt,
}


def eps_squared(eps: float) -> float:
    """eps^2 rounded once from f64 to f32 (repro/core/numerics.py:126),
    as the Python float the plain path adds and the kernels receive."""
    return float(torch.tensor(eps * eps, dtype=torch.float32))


def norm_eps_squared(eps: float, norm: str) -> float:
    """The eps^2 a norm flavor adds: (eps * MAG_SCALE)^2 in fixed mode,
    whose block vectors hold half-gray-unit counts, else eps^2."""
    return eps_squared(eps * quant.MAG_SCALE if norm == "fixed" else eps)


def finish_blocks(v: torch.Tensor, eps: float, norm: str) -> torch.Tensor:
    """(..., bd) raw block vectors -> (..., bd) L2-normalized f32 blocks
    (eq. 5): v * rsqrt(sum(v^2) + eps^2), put on the per-block int8 grid
    when norm == "fixed".

    In fixed mode v holds int16 histogram counts in half-gray units, so
    eps is scaled by quant.MAG_SCALE to stay the same relative
    regularizer (repro/core/numerics.py:104-132)."""
    try:
        rs = NORM_RSQRT[norm]
    except KeyError:
        raise ValueError(
            f"unknown norm flavor {norm!r}; expected one of "
            f"{sorted(NORM_RSQRT)}") from None
    v = v.to(torch.float32)
    ss = torch.sum(v * v, dim=-1, keepdim=True) + norm_eps_squared(eps, norm)
    out = v * rs(ss)
    if norm == "fixed":
        out = quant.quantize_dequantize(out)
    return out


def store_hist(hist: torch.Tensor) -> torch.Tensor:
    """Histogram accumulator -> stored dtype: int16 for integer (fixed
    chain) accumulators, passthrough for float."""
    if not hist.dtype.is_floating_point:
        return hist.to(torch.int16)
    return hist
