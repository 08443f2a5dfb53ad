"""Mamba-2 SSD (state-space duality) mixer -- arXiv:2405.21060 (port of
repro/models/ssm.py).

The chunked block-decomposition for prefill (an intra-chunk quadratic
term, in passes over runs of chunks (``layers.PASS_BYTES``), plus the
inter-chunk state recurrence, a loop over chunks here),
the one-step recurrence for decode. The selective-scan numerics run in
f32 (exp of the decay cumsums), the matmul-heavy terms in the model's
dtype, as in the reference. The parameters ``A_log``, ``D_skip`` and
``dt_bias`` are f32 whatever the model's dtype, and so are the cache's
``state`` and ``conv``.

Shapes (per layer): d_inner = expand*D, P = headdim, H = d_inner/P heads,
N = d_state, G = n_groups (B/C shared across H/G heads).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .configs import ModelConfig
from .layers import cat, passes, rmsnorm

Tensor = torch.Tensor
f32 = torch.float32


def _softplus(x: Tensor) -> Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` (logaddexp), without
    PyTorch's linear cut-over above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xBC: Tensor, w: Tensor, b: Tensor, k: int) -> Tensor:
    """Depthwise causal conv, width k, as k shifted adds in f32, then
    silu; xBC (B, S, C), w (C, k), b (C,)."""
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = torch.zeros(xBC.shape, dtype=f32, device=xBC.device)
    for j in range(k):
        out = out + pad[:, j:j + S, :].to(f32) * w[:, j]
    return F.silu(out + b).to(xBC.dtype)


def ssd_forward(x: Tensor, p, cfg: ModelConfig
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full-sequence SSD. x: (B, S, D) -> (y (B, S, D), the final cache
    {"state": (B, H, N, P), "conv": (B, k-1, conv_dim)}, both f32). The
    sequence is padded to a chunk multiple with dt = 0 on the padding
    (an identity state update, no output contribution); ``conv`` is the
    last k-1 raw (pre-conv) xBC rows, so S >= k-1."""
    B, S0, D = x.shape
    di, G, N, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_headdim)
    Q = min(cfg.ssm_chunk, S0)
    S = -(-S0 // Q) * Q
    if S != S0:
        x = F.pad(x, (0, 0, 0, S - S0))
    valid = (torch.arange(S, device=x.device) < S0)[None, :, None]
    nc = S // Q

    # the projection's pieces are copied out or consumed, so that its
    # (B, S, 2 d_inner + 2 G N + H) product is freed before the scan
    zxbcdt = torch.matmul(x, p.in_proj)
    z = zxbcdt[..., :di].clone()
    xBC = zxbcdt[..., di:di + cfg.conv_dim]
    dt_raw = zxbcdt[..., di + cfg.conv_dim:]
    conv_tail = xBC[:, S0 - (cfg.ssm_conv - 1):S0, :].to(f32)  # decode carry
    xBC = _causal_conv(xBC, p.conv_w, p.conv_b, cfg.ssm_conv)
    xs = xBC[..., :di]
    Bm = xBC[..., di:di + G * N].reshape(B, S, G, N)
    Cm = xBC[..., di + G * N:].reshape(B, S, G, N)

    dt = _softplus(dt_raw.to(f32) + p.dt_bias)               # (B, S, H)
    del zxbcdt, dt_raw
    dt = dt * valid                                          # mask the pad
    A = -torch.exp(p.A_log.to(f32))                          # (H,)
    dA = dt * A

    xh = xs.reshape(B, S, H, P)
    rep = H // G
    dAc = dA.reshape(B, nc, Q, H)
    dtc = dt.reshape(B, nc, Q, H)
    xc = xh.reshape(B, nc, Q, H, P)
    Bc = Bm.reshape(B, nc, Q, G, N)
    Cc = Cm.reshape(B, nc, Q, G, N)

    cum = torch.cumsum(dAc, dim=2)                           # (B, nc, Q, H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    runs = passes(nc, 4 * B * Q * Q * H)        # a chunk's (Q, Q, H) f32

    def intra(c: slice) -> Tuple[Tensor, Tensor]:
        """Chunks ``c``: the quadratic, attention-like term and each
        chunk's own state, sum_k exp(cum[last]-cum[k]) dt[k] B[k] x[k]."""
        cu, dtk, Bk = cum[:, c], dtc[:, c], Bc[:, c]
        CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc[:, c].to(f32),
                          Bk.to(f32))
        decay = torch.exp(cu[:, :, :, None, :] - cu[:, :, None, :, :])
        M = torch.where(tri[None, None, :, :, None], decay,
                        torch.zeros((), dtype=f32, device=x.device))
        M = M * dtk[:, :, None, :, :]                        # * dt[k]
        CBh = torch.repeat_interleave(CB, rep, dim=2)        # (B,nc,H,Q,K)
        W = CBh * torch.movedim(M, -1, 2)
        y_intra = torch.einsum("bchqk,bckhp->bcqhp", W.to(x.dtype), xc[:, c])
        seg = torch.exp(cu[:, :, -1:, :] - cu) * dtk         # (B,nc,Q,H)
        Bh = torch.repeat_interleave(Bk, rep, dim=3)         # (B,nc,Q,H,N)
        states = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", seg, Bh.to(f32),
                              xc[:, c].to(f32))
        return y_intra, states

    parts = [intra(c) for c in runs]
    states = cat([s_ for _, s_ in parts], 1)

    # the inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B, nc, H)
    st = torch.zeros((B, H, N, P), dtype=f32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)                  # (B,nc,H,N,P)

    ys = []
    for c, (y_intra, _) in zip(runs, parts):
        Ch = torch.repeat_interleave(Cc[:, c], rep, dim=3)   # (B,nc,Q,H,N)
        y_inter = torch.einsum("bcqh,bcqhn,bchnp->bcqhp", torch.exp(cum[:, c]),
                               Ch.to(f32), entering[:, c])
        ys.append(y_intra.to(f32) + y_inter)
    del parts
    y = cat(ys, 1).reshape(B, S, H, P)
    del ys
    y = y + p.D_skip.to(f32)[:, None] * xh.to(f32)
    y = y.reshape(B, S, di).to(x.dtype)[:, :S0]
    z = z[:, :S0]
    # gated RMSNorm, then the out projection
    y = rmsnorm(y * F.silu(z.to(f32)).to(x.dtype), p.norm_scale,
                cfg.norm_eps)
    out = torch.matmul(y, p.out_proj)
    return out, {"state": st, "conv": conv_tail}


def _conv_window(conv: Tensor, xBC_new: Tensor) -> Tensor:
    """The decode conv's k inputs (B, k, C): the cache's k-1 raw rows,
    then the new one, in f32."""
    return torch.cat([conv, xBC_new[:, None, :].to(f32)], dim=1)


def _state_update(state: Tensor, dec: Tensor, upd: Tensor) -> Tensor:
    """One recurrence step: the state (B, H, N, P) decayed per head by
    ``dec`` (B, H), plus this token's update."""
    return state * dec[..., None, None] + upd


def ssd_decode(x: Tensor, p, cfg: ModelConfig, cache: Dict[str, Tensor]
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token recurrent step. x: (B, 1, D), ``cache`` {"state",
    "conv"} as ``ssd_forward`` returns it -> (y (B, 1, D), the new cache,
    fresh tensors)."""
    B = x.shape[0]
    di, G, N, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_headdim)
    zxbcdt = torch.matmul(x, p.in_proj)[:, 0]                 # (B, E)
    z = zxbcdt[:, :di]
    xBC_new = zxbcdt[:, di:di + cfg.conv_dim]
    dt_raw = zxbcdt[:, di + cfg.conv_dim:]

    conv_buf = _conv_window(cache["conv"], xBC_new)          # (B, k, C)
    xBC = torch.einsum("bkc,ck->bc", conv_buf, p.conv_w.to(f32))
    xBC = F.silu(xBC + p.conv_b).to(x.dtype)

    xs = xBC[:, :di].reshape(B, H, P)
    Bm = xBC[:, di:di + G * N].reshape(B, G, N)
    Cm = xBC[:, di + G * N:].reshape(B, G, N)
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=1)             # (B, H, N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1)

    dt = _softplus(dt_raw.to(f32) + p.dt_bias)               # (B, H)
    A = -torch.exp(p.A_log.to(f32))
    dec = torch.exp(dt * A)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dt, Bh.to(f32), xs.to(f32))
    state = _state_update(cache["state"], dec, upd)

    y = torch.einsum("bhn,bhnp->bhp", Ch.to(f32), state)
    y = y + p.D_skip.to(f32)[:, None] * xs.to(f32)
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z.to(f32))[:, None].to(x.dtype), p.norm_scale,
                cfg.norm_eps)
    out = torch.matmul(y, p.out_proj)
    return out, {"state": state, "conv": conv_buf[:, 1:]}
