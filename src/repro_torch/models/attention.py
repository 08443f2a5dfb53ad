"""Attention: GQA, qk-norm, RoPE and KV-cache decode (port of
repro/models/attention.py, the dense family's part).

Prefill and full-sequence attention are causal over ``arange``
positions, the queries and keys the same sequence -- every prefill of
the dense family -- and take the hand-written flash kernel
(``kernels/flash_attention.py``). Single-token decode against the
padded cache takes ``_sdpa``, the reference's einsum attention in plain
torch, with the causal ``make_mask``.

Sliding windows, meta tokens, explicit and M-RoPE positions,
cross-attention and the banded and split-softmax variants come with the
hybrid, VLM and encoder-decoder slices.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels.flash_attention import flash_attention
from .configs import ModelConfig
from .layers import apply_rope, rmsnorm

Tensor = torch.Tensor

NEG_INF = -1e9  # the reference's mask value (survives f32 softmax)


def _project_qkv(x: Tensor, p, cfg: ModelConfig,
                 positions: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """x (B, S, D) -> q (B, S, H, hd), k and v (B, S, K, hd), with qk-norm
    and RoPE applied to q and k."""
    if cfg.mrope:
        raise NotImplementedError("M-RoPE comes with the VLM slice")
    B, S, D = x.shape
    hd = cfg.hd
    q = torch.matmul(x, p.wq).view(B, S, cfg.n_heads, hd)
    k = torch.matmul(x, p.wk).view(B, S, cfg.n_kv_heads, hd)
    v = torch.matmul(x, p.wv).view(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def make_mask(q_pos: Tensor, k_pos: Tensor) -> Tensor:
    """The causal boolean mask (..., Sq, Sk): True = attend (the key's
    position is at most the query's)."""
    return k_pos[..., None, :] <= q_pos[..., :, None]


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Tensor,
          cfg: ModelConfig) -> Tensor:
    """Grouped scaled-dot-product attention, the reference's plain einsum
    branch: scores in the input dtype, then f32 scaling, masking and
    softmax, the weights cast to v's dtype.

    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H = K * rep;
    mask (B, Sq, Sk) or broadcastable.
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    q = q.reshape(B, Sq, K, H // K, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", q, k).to(torch.float32)
    scores = scores * hd ** -0.5
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", w, v)
    return out.reshape(B, Sq, H, hd)


def attend(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal self-attention of a sequence at arange positions, q (B, S,
    H, hd), k and v (B, S, K, hd) -> (B, S, H, hd), through the flash
    kernel. The kernel reads the (B, H, S, hd) views through their
    strides, so no transpose is copied."""
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2)).transpose(1, 2)


def arange_positions(B: int, S: int, device) -> Tensor:
    """(B, S) positions 0..S-1 for every row."""
    return torch.arange(S, device=device).expand(B, S)


def attention(x: Tensor, p, cfg: ModelConfig) -> Tensor:
    """Full-sequence causal attention at arange positions (training /
    prefill without cache)."""
    B, S, D = x.shape
    q, k, v = _project_qkv(x, p, cfg, arange_positions(B, S, x.device))
    out = attend(q, k, v)
    return torch.matmul(out.reshape(B, S, cfg.n_heads * cfg.hd), p.wo)


def attention_decode(x: Tensor, p, cfg: ModelConfig,
                     cache: Dict[str, Tensor], positions: Tensor
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Single-token decode against a KV cache.

    x: (B, 1, D); cache: {"k", "v": (B, Smax, K, hd), "idx": int} --
    ``idx`` is the current length (the same for the whole batch). The new
    key and value are written into the cache tensors in place (the
    reference returns updated copies); the returned cache holds the same
    tensors and ``idx + 1``.
    """
    B, _, D = x.shape
    q, k_new, v_new = _project_qkv(x, p, cfg, positions)
    idx = cache["idx"]
    k, v = cache["k"], cache["v"]
    k[:, idx:idx + 1] = k_new.to(k.dtype)
    v[:, idx:idx + 1] = v_new.to(v.dtype)
    Smax = k.shape[1]
    k_pos = torch.arange(Smax, device=x.device)[None, :]
    mask = make_mask(positions[:, -1:], k_pos)
    out = _sdpa(q, k, v, mask, cfg)
    y = torch.matmul(out.reshape(B, 1, cfg.n_heads * cfg.hd), p.wo)
    return y, {"k": k, "v": v, "idx": idx + 1}
