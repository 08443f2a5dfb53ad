"""int8 block-quantized gradient mean with error feedback (port of
repro/train/grad_compress.py), in plain torch: the reference has no
kernel here.

Each shard quantizes its gradient plus its residual to int8 with one f32
scale per block of 2,048 values, keeps the quantization error as its new
residual, and the mean is taken over every shard's dequantized payload.
The reference's shards are the devices of a shard_map axis (all-gather of
payloads and scales); the port's are the data-parallel shards of
``train_step.make_ddp_train_step``, held as lists, one entry a shard:
``quantize_shards`` on each shard's device, ``mean_of_payloads`` on each
device that needs the mean.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
BLOCK = 2048


def _quantize(x: Tensor) -> Tuple[Tensor, Tensor]:
    """f32 (N,) -> (int8 payload (N / BLOCK rounded up, BLOCK), f32
    per-block scales): scale = max|x| / 127 + 1e-12, q = round(x /
    scale) (half to even) clipped to [-127, 127]."""
    n = x.shape[0]
    xp = F.pad(x, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = xp.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dequantize(q: Tensor, scale: Tensor, n: int) -> Tensor:
    return (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]


def quantize_shards(xs: Sequence[Tensor],
                    residuals: Optional[Sequence[Tensor]] = None
                    ) -> Tuple[List[Tuple[Tensor, Tensor]], List[Tensor]]:
    """Each shard's tensor plus its residual quantized on the shard's own
    device -> (its (int8 payload, f32 scales), its new f32 residual: the
    quantization error)."""
    payloads, errs = [], []
    for i, x in enumerate(xs):
        flat = x.to(torch.float32).reshape(-1)
        if residuals is not None:
            flat = flat + residuals[i].reshape(-1)
        q, scale = _quantize(flat)
        errs.append((flat - _dequantize(q, scale, flat.shape[0]))
                    .reshape(x.shape))
        payloads.append((q, scale))
    return payloads, errs


def mean_of_payloads(payloads: Sequence[Tuple[Tensor, Tensor]], shape,
                     dtype: torch.dtype, device) -> Tensor:
    """The mean of the shards' dequantized payloads, added on ``device``
    in shard order (so every device that takes it gets the same bits),
    in ``dtype``."""
    n = 1
    for d in shape:
        n *= d
    tot = None
    for q, scale in payloads:
        deq = _dequantize(q.to(device), scale.to(device), n)
        tot = deq if tot is None else tot + deq
    return (tot / len(payloads)).reshape(shape).to(dtype)


def init_residuals(params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Zero f32 residuals shaped as the parameters."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
