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

from typing import Dict, Optional, Tuple

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
    return _conv_rows(F.pad(xBC, (0, 0, k - 1, 0)), w, b, k)


def _conv_rows(pad: Tensor, w: Tensor, b: Tensor, k: int) -> Tensor:
    """``_causal_conv`` of the rows after the first k-1 of ``pad`` (B,
    k-1 + S, C), those k-1 the raw rows before them (zeros at the
    sequence's start) -> (B, S, C)."""
    S = pad.shape[1] - (k - 1)
    out = torch.zeros((pad.shape[0], S, pad.shape[2]), dtype=f32,
                      device=pad.device)
    for j in range(k):
        out = out + pad[:, j:j + S, :].to(f32) * w[:, j]
    return F.silu(out + b).to(pad.dtype)


def ssd_forward(x: Tensor, p, cfg: ModelConfig
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full-sequence SSD. x: (B, S, D) -> (y (B, S, D), the final cache
    {"state": (B, H, N, P), "conv": (B, k-1, conv_dim)}, both f32): one
    run holding the whole sequence through ``ssd_conv``, ``ssd_chunk``
    and ``ssd_chunk_out`` from a zero entering state. The sequence is
    padded to a chunk multiple with dt = 0 on the padding (an identity
    state update, no output contribution); ``conv`` is the last k-1 raw
    (pre-conv) xBC rows, zeros before the sequence."""
    S0 = x.shape[1]
    k1 = cfg.ssm_conv - 1
    Q = min(cfg.ssm_chunk, S0)
    S = -(-S0 // Q) * Q
    if S != S0:
        x = F.pad(x, (0, 0, 0, S - S0))
    # z is copied out and the raw rows copied behind their k-1 zeros, so
    # that the projection's (B, S, 2 d_inner + 2 G N + H) product is
    # freed before the conv, and the rows after it
    z, r = ssd_project(x, p, cfg)
    z = z[:, :S0].clone()
    rows = F.pad(r, (0, 0, k1, 0))
    del r
    conv = rows[:, S0:S0 + k1, :cfg.conv_dim].to(f32, copy=True)
    xBC, dt = ssd_conv(rows, p, cfg)
    del rows
    out, st = ssd_chunk_out(ssd_chunk(z, xBC, dt, 0, Q, p, cfg), None, p,
                            cfg)
    return out, {"state": st, "conv": conv}


def ssd_project(x: Tensor, p, cfg: ModelConfig
                ) -> Tuple[Tensor, Tensor]:
    """One run of a sequence, x (B, S, D), through ``in_proj`` -> (z (B,
    S, d_inner), the raw xBC and dt_raw side by side (B, S, conv_dim +
    H)): the first step of the SSD, whose chunks may begin on another
    device."""
    di = cfg.d_inner
    zxbcdt = torch.matmul(x, p.in_proj)
    return zxbcdt[..., :di], zxbcdt[..., di:]


def ssd_conv(rows: Tensor, p, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """The raw xBC and dt_raw rows of a run (B, k-1 + n, conv_dim + H),
    the first k-1 those before it (zeros at the sequence's start) -> (xBC
    after the causal conv (B, n, conv_dim), softplus(dt_raw + dt_bias)
    (B, n, H) f32) of the n rows after them."""
    k1, C = cfg.ssm_conv - 1, cfg.conv_dim
    xBC = _conv_rows(rows[..., :C], p.conv_w, p.conv_b, cfg.ssm_conv)
    return xBC, _softplus(rows[:, k1:, C:].to(f32) + p.dt_bias)


def ssd_chunk(z: Tensor, xBC: Tensor, dt: Tensor, lead: int, Q: int, p,
              cfg: ModelConfig) -> Dict[str, object]:
    """The local pass of the SSD over one run [s, e) of a sequence (the
    whole of it, or a context-parallel prefill's or train step's chunk
    of it on one device), on the whole sequence's chunk grid of Q =
    min(ssm_chunk, its length), so every product is the whole
    sequence's: ``z`` (B, e - s, d_inner) the run's; ``xBC`` and ``dt``
    (``ssd_conv``'s) of the rows from c0 = s - ``lead``, the first
    chunk's start (the rows before s from earlier devices), to e or
    past it (rows past e are padding). Runs the chunks from c0, the last
    padded with dt = 0: each chunk's intra-chunk term, own state (from a
    zero entering state) and total decay -> {"states" (B, nc, H, N, P)
    f32, "chunk_decay" (B, nc, H) f32, and the rest of what
    ``ssd_chunk_out`` reads}."""
    di, G, N, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_headdim)
    B, S0 = z.shape[0], lead + z.shape[1]
    S = -(-S0 // Q) * Q
    nc = S // Q
    if xBC.shape[1] < S:
        xBC, dt = (F.pad(t, (0, 0, 0, S - t.shape[1])) for t in (xBC, dt))
    valid = (torch.arange(S, device=z.device) < S0)[None, :, None]
    dt = dt[:, :S] * valid                                   # mask the pad
    xc = xBC[:, :S, :di].reshape(B, nc, Q, H, P)
    Bc = xBC[:, :S, di:di + G * N].reshape(B, nc, Q, G, N)
    Cc = xBC[:, :S, di + G * N:].reshape(B, nc, Q, G, N)
    dtc = dt.reshape(B, nc, Q, H)
    cum = torch.cumsum((dt * -torch.exp(p.A_log.to(f32))).reshape(
        B, nc, Q, H), dim=2)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=z.device).tril()
    runs = passes(nc, 4 * B * Q * Q * H)        # a chunk's (Q, Q, H) f32
    parts = [_intra(cum[:, c], dtc[:, c], Bc[:, c], Cc[:, c], xc[:, c], tri,
                    z.dtype) for c in runs]
    return {"lead": lead, "z": z, "runs": runs,
            "y_intra": [y for y, _ in parts],
            "states": cat([st for _, st in parts], 1),
            "chunk_decay": torch.exp(cum[:, :, -1, :]), "cum": cum,
            "C": Cc, "xh": xc}


def chunk_state(states: Tensor, chunk_decay: Tensor, n: int
                ) -> Tuple[Tensor, Tensor]:
    """The state the first ``n`` chunks of a local pass (``ssd_chunk``'s
    "states" and "chunk_decay") leave from a zero entering state, and
    their total decay -> ((B, H, N, P), (B, H)), both f32: the state E
    entering the next run then follows as E' = E * decay + state."""
    st = torch.zeros(states.shape[:1] + states.shape[2:], dtype=f32,
                     device=states.device)
    for c in range(n):
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    return st, torch.prod(chunk_decay[:, :n], 1)


def _intra(cu: Tensor, dtk: Tensor, Bk: Tensor, Ck: Tensor, xk: Tensor,
           tri: Tensor, dtype) -> Tuple[Tensor, Tensor]:
    """Chunks (B, n, Q, ...) of ``cum``, dt, B, C and x: the quadratic,
    attention-like term (``dtype``) and each chunk's own state, sum_k
    exp(cum[last]-cum[k]) dt[k] B[k] x[k] (f32)."""
    rep = xk.shape[3] // Bk.shape[3]
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Ck.to(f32), Bk.to(f32))
    # exp(cum[q] - cum[k]) where k <= q, 0 above: masked before the exp,
    # whose value there (positive, past 88 in a long chunk) is inf, and
    # whose gradient times the mask's zero would be NaN
    M = torch.exp(torch.where(tri[None, None, :, :, None],
                              cu[:, :, :, None, :] - cu[:, :, None, :, :],
                              -torch.inf))
    M = M * dtk[:, :, None, :, :]
    W = torch.repeat_interleave(CB, rep, dim=2) * torch.movedim(M, -1, 2)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", W.to(dtype), xk)
    seg = torch.exp(cu[:, :, -1:, :] - cu) * dtk
    Bh = torch.repeat_interleave(Bk, rep, dim=3)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", seg, Bh.to(f32),
                          xk.to(f32))
    return y_intra, states


def ssd_chunk_out(chunk: Dict[str, object], entering: Optional[Tensor], p,
                  cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """A run's output from its local pass (``ssd_chunk``), which it takes
    out of ``chunk`` as it uses it (each term freed once read), and the
    state entering its first chunk (B, H, N, P) f32 (None: zero, the
    sequence's first chunk): the state entering each chunk by the
    recurrence from it, each row's intra-chunk term plus exp(cum) C .
    entering, the D skip, gated RMSNorm and out projection; the rows
    before s dropped -> (y (B, e - s, D), the state after the run's last
    chunk (B, H, N, P) f32)."""
    z, lead = chunk.pop("z"), chunk["lead"]
    B, S0 = z.shape[:2]
    states, chunk_decay = chunk.pop("states"), chunk.pop("chunk_decay")
    st = entering if entering is not None else torch.zeros(
        states.shape[:1] + states.shape[2:], dtype=f32, device=z.device)
    ent = []
    for c in range(states.shape[1]):
        ent.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    del states, chunk_decay
    ent = torch.stack(ent, dim=1)                            # (B,nc,H,N,P)
    cum, Cc, xc = chunk.pop("cum"), chunk.pop("C"), chunk.pop("xh")
    parts = chunk.pop("y_intra")
    rep = xc.shape[3] // Cc.shape[3]
    ys = []
    for c, y_intra in zip(chunk["runs"], parts):
        Ch = torch.repeat_interleave(Cc[:, c], rep, dim=3)
        y_inter = torch.einsum("bcqh,bcqhn,bchnp->bcqhp", torch.exp(cum[:, c]),
                               Ch.to(f32), ent[:, c])
        ys.append(y_intra.to(f32) + y_inter)
    del parts
    nc, Q = cum.shape[1:3]
    y = cat(ys, 1).reshape(B, nc * Q, *xc.shape[3:])
    del ys
    y = y + p.D_skip.to(f32)[:, None] * xc.reshape(y.shape).to(f32)
    y = y.reshape(B, nc * Q, cfg.d_inner).to(z.dtype)[:, lead:lead + S0]
    y = rmsnorm(y * F.silu(z.to(f32)).to(z.dtype), p.norm_scale,
                cfg.norm_eps)
    return torch.matmul(y, p.out_proj), st


def _conv_window(conv: Tensor, xBC_new: Tensor) -> Tensor:
    """The decode conv's k inputs (B, k, C): the cache's k-1 raw rows,
    then the new one, in f32."""
    return torch.cat([conv, xBC_new[:, None, :].to(f32)], dim=1)


def _state_update(state: Tensor, dec: Tensor, upd: Tensor) -> Tensor:
    """One recurrence step: the state (B, H, N, P) decayed per head by
    ``dec`` (B, H), plus this token's update."""
    return state * dec[..., None, None] + upd


def ssd_decode_conv(conv: Tensor, xBC_new: Tensor, p, dtype
                    ) -> Tuple[Tensor, Tensor]:
    """A decode step's conv, as ``ssd_decode``'s: the cache's k-1 raw rows
    (B, k-1, C) f32 and the token's (B, C) -> (silu(conv + b) (B, C) in
    ``dtype``, the cache's new rows (B, k-1, C))."""
    buf = _conv_window(conv, xBC_new)
    xBC = torch.einsum("bkc,ck->bc", buf, p.conv_w.to(f32))
    return F.silu(xBC + p.conv_b).to(dtype), buf[:, 1:]


def ssd_decode_heads(xBC: Tensor, dt_raw: Tensor, z: Tensor, state: Tensor,
                     heads: slice, p, cfg: ModelConfig
                     ) -> Tuple[Tensor, Tensor]:
    """A decode step's recurrence on the SSM heads ``heads`` alone (one
    device's piece of the state), as ``ssd_decode`` steps them: xBC (B,
    C) after the conv, dt_raw (B, H), z (B, d_inner), ``state`` (B, h, N,
    P) f32 of those heads -> (their new state, their columns of y *
    silu(z) (B, 1, h P) in xBC's dtype: the gated RMSNorm's input)."""
    B = xBC.shape[0]
    di, G, N, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_headdim)
    rep = H // G
    xs = xBC[:, :di].reshape(B, H, P)[:, heads]
    Bh = torch.repeat_interleave(xBC[:, di:di + G * N].reshape(B, G, N),
                                 rep, dim=1)[:, heads]
    Ch = torch.repeat_interleave(xBC[:, di + G * N:].reshape(B, G, N),
                                 rep, dim=1)[:, heads]
    dt = _softplus(dt_raw.to(f32) + p.dt_bias)[:, heads]
    dec = torch.exp(dt * -torch.exp(p.A_log.to(f32))[heads])
    upd = torch.einsum("bh,bhn,bhp->bhnp", dt, Bh.to(f32), xs.to(f32))
    state = _state_update(state, dec, upd)
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(f32), state)
    y = y + p.D_skip.to(f32)[heads, None] * xs.to(f32)
    y = y.reshape(B, 1, -1).to(xBC.dtype)
    zc = z[:, heads.start * P:heads.stop * P]
    return state, y * F.silu(zc.to(f32))[:, None].to(xBC.dtype)


def ssd_decode(x: Tensor, p, cfg: ModelConfig, cache: Dict[str, Tensor]
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token recurrent step. x: (B, 1, D), ``cache`` {"state",
    "conv"} as ``ssd_forward`` returns it -> (y (B, 1, D), the new cache,
    fresh tensors)."""
    di, C = cfg.d_inner, cfg.conv_dim
    zxbcdt = torch.matmul(x, p.in_proj)[:, 0]                 # (B, E)
    xBC, conv = ssd_decode_conv(cache["conv"], zxbcdt[:, di:di + C], p,
                                x.dtype)
    state, y = ssd_decode_heads(xBC, zxbcdt[:, di + C:], zxbcdt[:, :di],
                                cache["state"], slice(0, cfg.ssm_heads), p,
                                cfg)
    y = rmsnorm(y, p.norm_scale, cfg.norm_eps)
    return torch.matmul(y, p.out_proj), {"state": state, "conv": conv}
