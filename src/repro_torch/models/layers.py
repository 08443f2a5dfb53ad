"""Primitive layers: norms, MLPs, RoPE / M-RoPE and whisper's sinusoidal
positions (port of repro/models/layers.py).

Each norm and MLP takes the parameter container of its layer (an
``nn.Module`` of ``models/model.py``, or anything with the same
attributes). The reference's ``jax.nn.gelu`` is the tanh approximation,
so ``gelu_mlp`` asks torch for it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale, in f32, returned in x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def layernorm(x: Tensor, scale: Tensor, bias: Tensor,
              eps: float = 1e-5) -> Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias, in f32 (the variance
    the mean of squared deviations, as ``jnp.var``), returned in x's
    dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    d = xf - mu
    var = torch.mean(d * d, dim=-1, keepdim=True)
    out = d * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def norm(x: Tensor, p, kind: str, eps: float) -> Tensor:
    """The configured norm; ``p.scale`` (and ``p.bias``) its weights."""
    if kind == "layernorm":
        return layernorm(x, p.scale, p.bias, eps)
    if kind == "rmsnorm":
        return rmsnorm(x, p.scale, eps)
    raise ValueError(f"unknown norm kind {kind!r}")


def swiglu(x: Tensor, p) -> Tensor:
    """SwiGLU MLP: silu(x W_gate) * (x W_up) W_down."""
    g = F.silu(torch.matmul(x, p.w_gate))
    u = torch.matmul(x, p.w_up)
    return torch.matmul(g * u, p.w_down)


def gelu_mlp(x: Tensor, p) -> Tensor:
    """gelu(x W_up) W_down, gelu's tanh approximation."""
    h = F.gelu(torch.matmul(x, p.w_up), approximate="tanh")
    return torch.matmul(h, p.w_down)


def mlp(x: Tensor, p, kind: str) -> Tensor:
    if kind == "swiglu":
        return swiglu(x, p)
    if kind == "gelu":
        return gelu_mlp(x, p)
    raise ValueError(f"unknown mlp kind {kind!r}")


# ---------------------------------------------------------------- RoPE

def rope_freqs(hd: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x: Tensor, ang: Tensor) -> Tensor:
    """x (B, S, H, hd) rotated by the angles ang (B, S, hd/2): the halves
    (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos), in f32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd), positions: (B, S) -> rotated x (same dtype)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # (hd/2,)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: Tensor, positions: Tensor, theta: float,
                sections: Tuple[int, int, int]) -> Tensor:
    """M-RoPE (qwen2-vl): positions (B, S, 3) = (t, h, w) indices. The
    hd/2 frequency slots split into three contiguous sections, each
    rotated by its own position stream; for text (t == h == w) it is
    RoPE."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to hd/2 "
                         f"= {hd // 2}")
    freqs = torch.split(rope_freqs(hd, theta, x.device), list(sections))
    pos = positions.to(torch.float32)
    # section j's slots times stream j (no index tensor to copy over)
    ang = torch.cat([pos[..., j:j + 1] * f for j, f in enumerate(freqs)],
                    dim=-1)                                # (B, S, hd/2)
    return _rotate(x, ang)


def sinusoidal_positions(n: int, d: int, device=None, start: int = 0
                         ) -> Tensor:
    """Whisper-style fixed sinusoidal embeddings of positions start ..
    start + n - 1, (n, d) f32: [sin | cos] of pos / 10000^(2i/d), the
    halves concatenated, not interleaved. Each row depends only on its
    position, so ``start`` gives rows of the reference's table alone."""
    pos = torch.arange(start, start + n, dtype=torch.float32,
                       device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# the most bytes one pass holds in each of its f32 intermediates where a
# long sequence is computed in runs of whole chunks (models/ssm.py) or
# blocks (models/attention.py:banded_core); each chunk's or block's
# numbers are the same in any run, so a 524,288-token prefill fits one card
PASS_BYTES = 1 << 30


def passes(n: int, bytes_each: int):
    """Runs of ``n`` chunks, blocks or rows, as slices, whose intermediates
    (``bytes_each`` a chunk) fit ``PASS_BYTES``: one run where all fit."""
    step = max(1, PASS_BYTES // bytes_each)
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def cat(parts, dim: int) -> Tensor:
    """``torch.cat``, without a copy of a single part."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)
