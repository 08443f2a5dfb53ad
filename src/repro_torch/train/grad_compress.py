"""int8 block-quantized gradient mean with error feedback (port of
repro/train/grad_compress.py), in plain torch: the reference has no
kernel here.

Each shard quantizes its gradient plus its residual to int8 with one f32
scale per block of 2,048 values, keeps the quantization error as its new
residual, and the mean is taken over every shard's dequantized payload.
The reference's shards are the devices of a shard_map axis (all-gather of
payloads and scales); the port's are the data-parallel shards of
``train_step.make_ddp_train_step``, held as lists, one entry a shard.
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


def compressed_mean(xs: Sequence[Tensor],
                    residuals: Optional[Sequence[Tensor]] = None
                    ) -> Tuple[Tensor, List[Tensor]]:
    """The mean of one tensor per shard (one shape), each quantized to
    int8 after adding its residual -> (the mean in the tensors' dtype,
    each shard's new f32 residual: its quantization error)."""
    shape, dtype = xs[0].shape, xs[0].dtype
    tot, errs = None, []
    for i, x in enumerate(xs):
        flat = x.to(torch.float32).reshape(-1)
        if residuals is not None:
            flat = flat + residuals[i].reshape(-1)
        q, scale = _quantize(flat)
        deq = _dequantize(q, scale, flat.shape[0])
        errs.append((flat - deq).reshape(shape))
        tot = deq if tot is None else tot + deq
    mean = tot / len(xs)
    return mean.reshape(shape).to(dtype), errs


def compress_tree_mean(grads: Sequence[Dict[str, Tensor]],
                       residuals: Optional[Sequence[Dict[str, Tensor]]]
                       = None
                       ) -> Tuple[Dict[str, Tensor], List[Dict[str, Tensor]]]:
    """``compressed_mean`` leaf by leaf over the shards' gradient dicts
    -> (the mean dict, one residual dict a shard)."""
    out, errs = {}, [dict() for _ in grads]
    for name in grads[0]:
        res = None if residuals is None else [r[name] for r in residuals]
        out[name], e = compressed_mean([g[name] for g in grads], res)
        for d, x in zip(errs, e):
            d[name] = x
    return out, errs


def init_residuals(params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Zero f32 residuals shaped as the parameters."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
