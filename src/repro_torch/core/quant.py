"""int8 descriptor quantization of the fixed-point datapath -- the port of
repro/core/quant.py.

  * block vectors quantize to int8 with one scale per 36-value block:
    scale = max|v| * f32(1/127), q = rint(v / scale), and back as
    q * scale, the fixed chain's public f32 block grid;
  * SVM weights quantize per window-offset column the same way;
  * the int32 scoring product rescales with a fixed multiply order.

Requantizing a dequantized grid recovers its codes exactly, so the
scorer (core/detector.py:score_blocks) recovers (q, scale) from the
block grid the stage chain returns.

The arithmetic matches the reference op for op: the scale is a multiply
by the f32 rounding of 1/127, never a divide; ``v / safe`` is an IEEE f32
divide of two tensors; ``torch.round`` rounds half to even, as
``jnp.rint``.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

Q_MAX = 127.0        # symmetric int8 code range [-127, 127]

#: fixed-chain magnitudes are stored in units of 2 gray levels, so a
#: 64-px cell sums to <= 64 * 361 = 23104 < 2^15 (repro/core/quant.py:48)
MAG_SCALE = 0.5

#: 1/127 rounded to f32, as ``jnp.float32(1.0 / Q_MAX)``
_INV_Q = float(torch.tensor(1.0 / Q_MAX, dtype=torch.float32))


def _codes(v: Tensor, dim: int) -> Tuple[Tensor, Tensor]:
    m = torch.amax(torch.abs(v), dim=dim, keepdim=True)
    scale = m * _INV_Q
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(v / safe).to(torch.int8), scale


def quantize_blocks(v: Tensor) -> Tuple[Tensor, Tensor]:
    """(..., bd) f32 block vectors -> (int8 codes, (...) f32 per-block
    scale); a zero block gets scale 0 and all-zero codes."""
    q, scale = _codes(v, -1)
    return q, scale[..., 0]


def dequantize_blocks(q: Tensor, scale: Tensor) -> Tensor:
    """Inverse of quantize_blocks: (..., bd) int8 + (...) scale -> f32."""
    return q.to(torch.float32) * scale[..., None]


def quantize_dequantize(v: Tensor) -> Tensor:
    """Round v onto its per-block int8 grid."""
    return dequantize_blocks(*quantize_blocks(v))


def quantize_weight_columns(wt: Tensor) -> Tuple[Tensor, Tensor]:
    """(K, N) f32 weights -> (int8 codes, (N,) f32 per-column scale)."""
    q, scale = _codes(wt, 0)
    return q, scale[0]


def rescale_scores(contrib_i32: Tensor, row_scale: Tensor,
                   col_scale: Tensor) -> Tensor:
    """(M, N) int32 * row (M,) * col (N,) -> (M, N) f32, in the
    reference's order: (ci * row) * col."""
    return (contrib_i32.to(torch.float32)
            * row_scale[:, None]) * col_scale[None, :]
