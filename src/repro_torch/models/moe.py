"""Mixture-of-Experts FFN (port of repro/models/moe.py, its local path).

Top-k routing into per-expert capacity buffers with token dropping (the
GShard/Switch discipline), a SwiGLU per expert as batched matmuls over
every expert's buffer, and the weighted combine back to token order;
llama4's always-on shared expert is added on top.

The reference's expert-parallel paths (``ShardingCtx``, ``_moe_ep_a2a``
and ``_moe_ep_replicated``) come with the LM meshes of a later slice:
``moe_ffn`` takes no ``ctx`` and always runs the local path, which is
the reference's path without a mesh.

Order and determinism, where the card would otherwise differ from the
CPU and the reference:
  * top-k is a stable descending sort: ties keep the lower expert first,
    as ``lax.top_k`` does (``torch.topk`` does not promise it);
  * the dispatch adds each kept token into its (expert, slot) once and
    the dropped ones' zeros into slot C - 1, as the reference's
    ``buf.at[e, slot].add`` does; adding zeros is exact in any order;
  * the combine adds each token's k contributions in slot order 0 .. k-1,
    each add rounded in the model's dtype, as the reference's
    sequential scatter-add over ``tok_ids = repeat(arange(T), k)`` does,
    instead of an atomic ``index_add_`` whose order varies.

``_capacity`` depends on the token count of the call: a prefill of T
tokens and a decode step of B tokens have different capacities, and an
overflowing expert drops the latest tokens first.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .configs import ModelConfig
from .layers import swiglu

Tensor = torch.Tensor


def _top_k(gates: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest gates of each row and their expert ids, largest
    first, the lower id first among equal gates (``lax.top_k``'s order)."""
    w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return w[:, :k], idx[:, :k]


def _route(x_flat: Tensor, gates: Tensor, cfg: ModelConfig,
           capacity: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Top-k routing into per-expert capacity buffers.

    x_flat: (T, D), gates: (T, E) f32 probabilities. Returns (buf (E, C,
    D), tok_ids (T*k,), slot (T*k,), weight (T*k,) in x's dtype); slot
    == C means dropped. A token's rank in its expert counts the earlier
    (token, choice) pairs routed there, token-major."""
    T, D = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    w, e_idx = _top_k(gates, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalize
    e_flat = e_idx.reshape(-1)
    w_flat = w.reshape(-1).to(x_flat.dtype)
    tok_ids = torch.arange(T, device=x_flat.device).repeat_interleave(k)
    onehot = F.one_hot(e_flat, E)
    ranks = torch.cumsum(onehot, dim=0) - onehot           # place in expert
    slot = ranks.gather(1, e_flat[:, None])[:, 0]
    keep = slot < capacity
    slot_c = torch.where(keep, slot, capacity - 1)
    contrib = torch.where(keep[:, None], x_flat[tok_ids],
                          x_flat.new_zeros(()))
    buf = x_flat.new_zeros((E, capacity, D))
    buf.index_put_((e_flat, slot_c), contrib, accumulate=True)
    slot_out = torch.where(keep, slot, capacity)           # C == dropped
    return buf, tok_ids, slot_out, w_flat


def _expert_ffn(buf: Tensor, wg: Tensor, wu: Tensor, wd: Tensor) -> Tensor:
    """(E, C, D) through each expert's SwiGLU -> (E, C, D)."""
    g = F.silu(torch.bmm(buf, wg))
    u = torch.bmm(buf, wu)
    return torch.bmm(g * u, wd)


def _combine(out_buf: Tensor, e_flat_slots: Tuple[Tensor, Tensor],
             w_flat: Tensor, T: int) -> Tensor:
    """Gather expert outputs back to token order and add each token's k
    weighted contributions, slot 0 first; the (expert, slot) pairs and
    weights come token-major, k a token, as ``_route`` emits them (its
    ``tok_ids`` are ``repeat(arange(T), k)``). A dropped slot contributes
    zeros."""
    e_flat, slot = e_flat_slots
    E, C, D = out_buf.shape
    padded = torch.cat([out_buf, out_buf.new_zeros((E, 1, D))], dim=1)
    vals = (padded[e_flat, slot] * w_flat[:, None]).view(T, -1, D)
    y = out_buf.new_zeros((T, D))
    for j in range(vals.shape[1]):
        y = y + vals[:, j]
    return y


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, int(c))


def _moe_local(x: Tensor, p, cfg: ModelConfig) -> Tensor:
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    gates = torch.softmax(torch.matmul(xf, p.router).to(torch.float32), -1)
    C = _capacity(T, cfg)
    buf, _, slot, w_flat = _route(xf, gates, cfg, C)
    out_buf = _expert_ffn(buf, p.w_gate, p.w_up, p.w_down)
    e_flat = _top_k(gates, cfg.top_k)[1].reshape(-1)
    y = _combine(out_buf, (e_flat, slot), w_flat, T)
    return y.reshape(B, S, D)


def moe_ffn(x: Tensor, p, cfg: ModelConfig) -> Tensor:
    """MoE FFN of x (B, S, D), with llama4's shared expert when the
    config has one. ``p`` holds ``router`` (D, E), ``w_gate``/``w_up``
    (E, D, F), ``w_down`` (E, F, D) and, shared, ``shared`` (an MLP)."""
    y = _moe_local(x, p, cfg)
    if cfg.shared_expert:
        y = y + swiglu(x, p.shared)
    return y
