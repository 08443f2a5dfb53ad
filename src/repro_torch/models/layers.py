"""Primitive layers: RMSNorm, SwiGLU MLP, RoPE (port of
repro/models/layers.py, the dense family's part).

``layernorm`` and ``gelu_mlp`` come with the whisper slice (note: the
reference's ``jax.nn.gelu`` is the tanh approximation), ``apply_mrope``
with qwen2-vl and ``sinusoidal_positions`` with the encoder-decoder.

Each takes the parameter container of its layer (an ``nn.Module`` of
``models/model.py``, or anything with the same attributes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale, in f32, returned in x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def norm(x: Tensor, p, kind: str, eps: float) -> Tensor:
    """The configured norm; ``p.scale`` is its weight."""
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm {kind!r}: layernorm comes with the encoder-decoder "
            f"(whisper) slice of the port")
    return rmsnorm(x, p.scale, eps)


def swiglu(x: Tensor, p) -> Tensor:
    """SwiGLU MLP: silu(x W_gate) * (x W_up) W_down."""
    g = F.silu(torch.matmul(x, p.w_gate))
    u = torch.matmul(x, p.w_up)
    return torch.matmul(g * u, p.w_down)


def mlp(x: Tensor, p, kind: str) -> Tensor:
    if kind != "swiglu":
        raise NotImplementedError(
            f"mlp {kind!r}: gelu_mlp comes with the encoder-decoder "
            f"(whisper) slice of the port")
    return swiglu(x, p)


# ---------------------------------------------------------------- RoPE

def rope_freqs(hd: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd), positions: (B, S) -> rotated x (same dtype)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)
