"""Attention: GQA, qk-norm, RoPE / M-RoPE, sliding windows with
meta-token sinks, cross-attention and KV-cache decode (port of
repro/models/attention.py).

Causal attention with no window whose mask is index-causal -- arange
positions, or explicit ones whose t stream strictly rises along every
row, which ``index_causal`` decides on a host copy -- takes the
hand-written flash kernel (``kernels/flash_attention.py``): every layer
of the dense and MoE families, hymba's global layers (meta tokens are
plain causal positions), whisper's decoder and qwen2-vl's text prompts.
The encoder's attention, every key visible, takes the same kernel with
``causal=False``. Where grad is enabled (training) the kernel runs
through ``FlashAttention``, whose backward is a hand-written kernel too;
every other path differentiates as plain torch through autograd. Any
other mask -- a window, or positions whose t repeats (an image's patches
share one t and see each other both ways) -- takes ``_sdpa``, the
reference's einsum attention in plain torch, under ``make_mask`` of the
t stream (the reference's default path), or, for a window under ``ctx.banded``,
``banded_core``: block-banded attention whose band and meta-prefix
partial softmaxes merge by log-sum-exp. A ``ctx`` (models/moe.py:
``ShardingCtx``) chooses among the masked paths as the reference's does:
``bf16_scores`` computes ``_sdpa``'s and ``banded_core``'s scores in
bf16, ``flash_vjp`` takes ``_sdpa``'s masked full-sequence form from the
reference's ``sdpa_flash`` (p rounded to v's dtype before the
normalization); neither touches the flash kernel's layers, which take it
under every profile. Cross-attention (queries and keys of other
lengths, no RoPE, no mask) and single-token decode against the padded
cache take ``_sdpa``; ``attention_decode_windowed`` reads only the live
window and the meta prefix.

Serving and training over a grid's "model" axis (models/model.py's
model path) add two forms: ``attend_chunk``, one device's chunk of a
context-parallel prefill or train step -- its queries against the whole
sequence's keys, through the flash kernel at the chunk's offset
(``q_offset``; in training its forward and backward through
``FlashAttention``), or ``_sdpa`` under the chunk's rows of
``make_mask`` (an image prompt, a window), differentiable either way;
an encoder chunk takes ``attend(..., causal=False)`` with Sq < Sk --
and
``decode_scores`` / ``decode_values``, single-token attention over one
device's length piece of the cache: the scores gathered over the
devices for the whole cache's softmax, then the P.V shares summed in
model-index order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import FlashAttention, flash_attention
from .configs import ModelConfig
from .layers import apply_mrope, apply_rope, cat, passes, rmsnorm

Tensor = torch.Tensor

NEG_INF = -1e9  # the reference's mask value (survives f32 softmax)


def _project_qkv(x: Tensor, p, cfg: ModelConfig,
                 positions: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """x (B, S, D) -> q (B, S, H, hd), k and v (B, S, K, hd), with qk-norm
    and RoPE applied to q and k: M-RoPE of (B, S, 3) positions where the
    config has it, else RoPE of the (B, S) positions (of the t stream of
    (B, S, 3) ones)."""
    return qkv_heads(torch.matmul(x, p.wq), torch.matmul(x, p.wk),
                     torch.matmul(x, p.wv), p, cfg, positions)


def qkv_heads(q: Tensor, k: Tensor, v: Tensor, p, cfg: ModelConfig,
              positions: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The projections (B, S, H*hd) and (B, S, K*hd) as heads, qk-norm and
    RoPE (M-RoPE) applied to q and k: ``_project_qkv`` after its
    matmuls. Tensor-parallel decode calls it on the gathered projections:
    a device's columns may end inside a head."""
    B, S, _ = q.shape
    hd = cfg.hd
    q = q.view(B, S, cfg.n_heads, hd)
    k = k.view(B, S, cfg.n_kv_heads, hd)
    v = v.view(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        pos = t_stream(positions)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def t_stream(positions: Tensor) -> Tensor:
    """The (B, S) positions masks read: ``positions`` itself, or the t
    stream of (B, S, 3) M-RoPE positions."""
    return positions if positions.dim() == 2 else positions[..., 0]


def index_causal(positions) -> bool:
    """Whether the causal mask of ``positions`` ((B, S) or (B, S, 3),
    numpy or a tensor; None = arange) is the index-causal mask the flash
    kernel computes, key j visible to query i iff j <= i: so it is iff
    every row's t strictly rises. Decided only on a host copy (numpy or
    a CPU tensor): a tensor on the card is not read, which would wait
    for the device, and counts as not index-causal."""
    if positions is None:
        return True
    t = t_stream(torch.as_tensor(positions))
    if t.device.type != "cpu":
        return False
    return bool((t[:, 1:] > t[:, :-1]).all())


def make_mask(q_pos: Tensor, k_pos: Tensor, *, causal: bool = True,
              window: int = 0, n_meta: int = 0) -> Tensor:
    """The boolean mask (..., Sq, Sk): True = attend. ``causal``: the
    key's position is at most the query's; ``window`` > 0 restricts it
    to the last ``window`` keys, while the first ``n_meta`` keys
    (hymba's meta tokens) stay visible through the window (attention
    sinks)."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    m = dk <= dq if causal else torch.ones(
        torch.broadcast_shapes(dq.shape, dk.shape), dtype=torch.bool,
        device=dq.device)
    if window > 0:
        m = m & ((dk > dq - window) | (dk < n_meta))
    return m


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
          cfg: ModelConfig, ctx=None) -> Tensor:
    """Grouped scaled-dot-product attention, the reference's einsum
    branches: by default scores in the input dtype, then f32 scaling,
    masking and softmax, the weights cast to v's dtype; under
    ``ctx.flash_vjp`` (masked, Sq > 1) ``sdpa_flash``'s forward; under
    ``ctx.bf16_scores`` every score tensor in bf16, the exp and the sums
    in f32.

    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H = K * rep;
    mask (B, Sq, Sk) or broadcastable, or None (every key visible).
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    if ctx is not None and ctx.flash_vjp and Sq > 1 and mask is not None:
        return _sdpa_lse(q, k, v, mask, fill=NEG_INF)[0]
    q = q.reshape(B, Sq, K, H // K, hd)
    if ctx is not None and ctx.bf16_scores:
        bf16 = torch.bfloat16
        scores = torch.einsum("bqkrh,bskh->bkrqs", q, k).to(bf16)
        scores = scores * torch.tensor(hd ** -0.5, dtype=bf16)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :, :], -3e4)
        m = scores.amax(-1, keepdim=True)
        p = torch.exp((scores - m).to(torch.float32)).to(bf16)
        l = p.sum(-1, keepdim=True, dtype=torch.float32)
        w = (p / l.to(bf16)).to(v.dtype)
    else:
        scores = torch.einsum("bqkrh,bskh->bkrqs", q, k).to(torch.float32)
        scores = scores * hd ** -0.5
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", w, v)
    return out.reshape(B, Sq, H, hd)


def attend(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
           q_offset: int = 0) -> Tensor:
    """Self-attention of a sequence, q (B, S, H, hd), k and v (B, S, K,
    hd) -> (B, S, H, hd), through the flash kernel: index-causal, or
    every key visible. The kernel reads the (B, H, S, hd) views through
    their strides, so no transpose is copied. Where grad is enabled
    (training) it goes through ``FlashAttention``, whose backward is the
    hand-written backward kernel; serving (inference mode) calls the
    forward alone. ``q_offset``: q is a chunk of Sq queries at key
    positions q_offset on, against Sk >= q_offset + Sq keys (a
    context-parallel prefill's or train step's chunk; ``FlashAttention``'s
    backward takes the same offset)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    at = {"q_offset": q_offset} if q_offset else {}
    if torch.is_grad_enabled():
        out = FlashAttention.apply(qt, kt, vt, causal, *at.values())
    else:
        out = flash_attention(qt, kt, vt, causal=causal, **at)
    return out.transpose(1, 2)


def attend_chunk(q: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig,
                 q_pos: Tensor, k_pos: Tensor, q_offset: int, *,
                 window: int = 0, n_meta: int = 0, ctx=None,
                 flash: bool = True) -> Tensor:
    """One device's chunk of a context-parallel prefill or train step
    (differentiable where grad is enabled): its queries q
    (B, Sq, H, hd), at sequence positions q_offset .. q_offset + Sq - 1
    and (B, Sq) mask positions ``q_pos``, against the whole sequence's k
    and v (B, Sk, K, hd) at ``k_pos`` (B, Sk), gathered in model-index
    order. No window and ``flash`` (the positions index-causal): the
    flash kernel at ``q_offset``. A window reads only its band: under
    ``ctx.banded`` ``banded_core`` at the chunk's offset (the row path's
    blocks); else, where ``flash`` (a key more than a window before the
    query by index is outside it), ``_sdpa`` over the meta keys and the
    keys from q_offset - window + 1 on, under their rows of the
    reference's ``make_mask``. Otherwise ``_sdpa`` under the chunk's
    rows of the whole mask (an image prompt's t stream)."""
    if not window and flash:
        return attend(q, k, v, q_offset=q_offset)
    if window and ctx is not None and ctx.banded:
        return banded_core(q, k, v, q_pos, cfg, window=window, n_meta=n_meta,
                           ctx=ctx, q_offset=q_offset, k_pos=k_pos)
    if window and flash:
        lo = max(n_meta, q_offset - window + 1)
        hi = q_offset + q.shape[1]
        if lo > n_meta:
            k, v, k_pos = (torch.cat([t[:, :n_meta], t[:, lo:hi]], 1)
                           for t in (k, v, k_pos))
        else:
            k, v, k_pos = k[:, :hi], v[:, :hi], k_pos[:, :hi]
    return _sdpa(q, k, v, make_mask(q_pos, k_pos, window=window,
                                    n_meta=n_meta), cfg, ctx)


def self_attend(q: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig,
                pos: Tensor, *, window: int = 0, n_meta: int = 0,
                ctx=None, flash: bool = True) -> Tensor:
    """Causal self-attention of a sequence (q (B, S, H, hd), k and v (B,
    S, K, hd)) at the (B, S) positions ``pos`` with the layer's window:
    none and ``flash`` (``pos`` index-causal) -> the flash kernel; a
    window -> ``banded_core`` under ``ctx.banded``; else ``_sdpa`` under
    ``make_mask`` of ``pos``."""
    if not window and flash:
        return attend(q, k, v)
    if window and ctx is not None and ctx.banded:
        return banded_core(q, k, v, pos, cfg, window=window, n_meta=n_meta,
                           ctx=ctx)
    return _sdpa(q, k, v, make_mask(pos, pos, window=window,
                                    n_meta=n_meta), cfg, ctx)


def arange_positions(B: int, S: int, device) -> Tensor:
    """(B, S) positions 0..S-1 for every row."""
    return torch.arange(S, device=device).expand(B, S)


def attention(x: Tensor, p, cfg: ModelConfig,
              positions: Optional[Tensor] = None, *, window: int = 0,
              n_meta: int = 0, causal: bool = True, ctx=None) -> Tensor:
    """Full-sequence attention (training / prefill without cache) at
    ``positions`` ((B, S), (B, S, 3) for M-RoPE, or None: arange),
    windowed if ``window`` > 0; ``causal=False`` (the encoder) lets every
    query see every key, through the flash kernel."""
    B, S, D = x.shape
    flash = index_causal(positions)
    if positions is None:
        positions = arange_positions(B, S, x.device)
    positions = torch.as_tensor(positions, device=x.device)
    q, k, v = _project_qkv(x, p, cfg, positions)
    if causal:
        out = self_attend(q, k, v, cfg, t_stream(positions), window=window,
                          n_meta=n_meta, ctx=ctx, flash=flash)
    else:
        out = attend(q, k, v, causal=False)
    return torch.matmul(out.reshape(B, S, cfg.n_heads * cfg.hd), p.wo)


def cross_attention(x: Tensor, enc: Tensor, p, cfg: ModelConfig) -> Tensor:
    """Decoder cross-attention over encoder states (whisper): queries of
    x (B, S, D), keys and values of enc (B, T, D), no RoPE and no mask,
    through ``_sdpa`` (a flash route for it is queued: ROADMAP.md queue
    2 (f)); a context-parallel prefill or train step calls it on each
    device's chunk of queries against the whole states."""
    B, S, D = x.shape
    T, hd = enc.shape[1], cfg.hd
    q = torch.matmul(x, p.wq).view(B, S, cfg.n_heads, hd)
    k = torch.matmul(enc, p.wk).view(B, T, cfg.n_kv_heads, hd)
    v = torch.matmul(enc, p.wv).view(B, T, cfg.n_kv_heads, hd)
    out = _sdpa(q, k, v, None, cfg)
    return torch.matmul(out.reshape(B, S, cfg.n_heads * hd), p.wo)


def attention_decode(x: Tensor, p, cfg: ModelConfig,
                     cache: Dict[str, Tensor], positions: Tensor, *,
                     window: int = 0, n_meta: int = 0
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Single-token decode against a KV cache.

    x: (B, 1, D); positions (B, 1), or (B, 1, 3) for M-RoPE; cache:
    {"k", "v": (B, Smax, K, hd), "idx": int} -- ``idx`` is the current
    length (the same for the whole batch). The new
    key and value are written into the cache tensors in place (the
    reference returns updated copies); the returned cache holds the same
    tensors and ``idx + 1``. The mask reads the whole padded cache,
    windowed if ``window`` > 0.
    """
    B, _, D = x.shape
    q, k, v, idx = _decode_qkv(x, p, cfg, cache, positions)
    Smax = k.shape[1]
    k_pos = torch.arange(Smax, device=x.device)[None, :]
    mask = make_mask(t_stream(positions)[:, -1:], k_pos, window=window,
                     n_meta=n_meta)
    out = _sdpa(q, k, v, mask, cfg)
    y = torch.matmul(out.reshape(B, 1, cfg.n_heads * cfg.hd), p.wo)
    return y, {"k": k, "v": v, "idx": idx + 1}


def _decode_qkv(x: Tensor, p, cfg: ModelConfig, cache: Dict[str, Tensor],
                positions: Tensor):
    """Project one token and write its key and value into the cache at
    ``idx``, in place -> (q, the cache's k and v, idx)."""
    q, k_new, v_new = _project_qkv(x, p, cfg, positions)
    idx = cache["idx"]
    k, v = cache["k"], cache["v"]
    k[:, idx:idx + 1] = k_new.to(k.dtype)
    v[:, idx:idx + 1] = v_new.to(v.dtype)
    return q, k, v, idx


def decode_scores(q: Tensor, k: Tensor, q_pos: Tensor, k_start: int, *,
                  window: int = 0, n_meta: int = 0) -> Tensor:
    """One device's scores of a decode step: q (B, 1, H, hd) against its
    length piece of the cache, k (B, Lp, K, hd) at key positions k_start
    .. k_start + Lp - 1, as ``_sdpa`` makes them over the whole cache --
    the product in the inputs' dtype, then f32, scaled, masked to -1e9
    under the reference's ``make_mask`` of the query's t position
    ``q_pos`` (B, 1) -> (B, K, rep, 1, Lp) f32. Gathered over the
    pieces in model-index order, their softmax is the whole cache's
    (models/model.py)."""
    B, _, H, hd = q.shape
    K = k.shape[2]
    k_pos = torch.arange(k_start, k_start + k.shape[1],
                         device=q.device)[None, :]
    mask = make_mask(q_pos, k_pos, window=window, n_meta=n_meta)
    s = torch.einsum("bqkrh,bskh->bkrqs", q.reshape(B, 1, K, H // K, hd),
                     k).to(torch.float32)
    return (s * hd ** -0.5).masked_fill(~mask[:, None, None, :, :], NEG_INF)


def decode_values(w: Tensor, v: Tensor) -> Tensor:
    """One device's share of a decode step's output: its normalized
    weights w (B, K, rep, 1, Lp) f32, rounded to v's dtype as ``_sdpa``
    rounds them, times its piece of v (B, Lp, K, hd), products and sums
    in f32 -> (B, 1, H, hd) f32; the shares' sum, rounded once, is the
    whole cache's P.V."""
    B, K, rep, _, _ = w.shape
    out = torch.einsum("bkrqs,bskh->bqkrh", w.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(B, 1, K * rep, v.shape[-1])


def _sdpa_lse(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
              bf16: bool = False, fill: float = -3e4
              ) -> Tuple[Tensor, Tensor]:
    """SDPA returning (normalized out (B, Sq, H, hd), lse (B, Sq, H)) for
    split-softmax merging: scores of the inputs' exact products in f32
    (in bf16 where ``bf16``, the reference's bf16 branch), masked to
    ``fill``, p = exp(s - max) in f32 rounded to v's dtype before the P.V
    product, its f32 sum the normalizer. With ``fill`` -1e9 its output is
    the reference's ``sdpa_flash`` forward."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    q5 = q.reshape(B, Sq, K, H // K, hd)
    pt = torch.bfloat16 if bf16 else torch.float32
    if bf16:
        scores = torch.einsum("bqkrh,bskh->bkrqs", q5, k).to(pt)
    else:
        scores = torch.einsum("bqkrh,bskh->bkrqs", q5.to(pt), k.to(pt))
    scores = scores * (torch.tensor(hd ** -0.5, dtype=pt) if bf16
                       else hd ** -0.5)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :, :], fill)
    m = scores.amax(-1).to(torch.float32)                   # (B,K,rep,Sq)
    p = torch.exp((scores - m[..., None].to(pt)).to(torch.float32)
                  ).to(v.dtype)
    l = p.sum(-1, dtype=torch.float32)
    out = torch.einsum("bkrqs,bskh->bqkrh", p, v).reshape(B, Sq, H, hd)
    lc = torch.clamp(l, min=1e-30)
    out = out / lc.reshape(B, H, Sq).transpose(1, 2)[..., None].to(
        out.dtype)
    lse = (m + torch.log(lc)).reshape(B, H, Sq).transpose(1, 2)
    return out, lse


def banded_attention(x: Tensor, p, cfg: ModelConfig, *, window: int,
                     n_meta: int = 0, ctx=None) -> Tensor:
    """Block-banded sliding-window attention of x (B, S, D) at arange
    positions: each block of ``window`` queries attends to the key band
    [previous block; its block] and, apart, to the meta prefix; the two
    partial softmaxes merge by log-sum-exp. The masked baseline's
    function at O(S (2 window + n_meta)) instead of O(S^2)."""
    B, S, D = x.shape
    pos = arange_positions(B, S, x.device)
    q, k, v = _project_qkv(x, p, cfg, pos)
    out = banded_core(q, k, v, pos, cfg, window=window, n_meta=n_meta,
                      ctx=ctx)
    return torch.matmul(out.reshape(B, S, cfg.n_heads * cfg.hd), p.wo)


def banded_core(q: Tensor, k: Tensor, v: Tensor, pos1d: Tensor,
                cfg: ModelConfig, *, window: int, n_meta: int = 0,
                ctx=None, q_offset: int = 0,
                k_pos: Optional[Tensor] = None) -> Tensor:
    """Banded attention on projected q (B, S, H, hd), k and v (B, S, K,
    hd) at positions ``pos1d`` (B, S) -> (B, S, H, hd); the partial
    softmaxes' scores in bf16 under ``ctx.bf16_scores``. ``q_offset``,
    ``k_pos``: q is a chunk of a sequence, at sequence rows q_offset on
    and positions ``pos1d``, against the whole sequence's k and v at
    ``k_pos`` (B, Sk) (a context-parallel chunk): the whole sequence's
    blocks and bands, the chunk's rows of them."""
    bf16 = bool(ctx is not None and ctx.bf16_scores)
    B, Sq, H, hd = q.shape
    if k_pos is None:
        k_pos = pos1d
    Sk, bq = k.shape[1], window
    a = q_offset // bq * bq                  # the chunk's first block
    lead = q_offset - a
    nblk = -(-(lead + Sq) // bq)
    Sp = nblk * bq
    big = 2 ** 30
    qp = F.pad(pos1d, (lead, Sp - lead - Sq), value=big)
    qb = F.pad(q, (0, 0, 0, 0, lead, Sp - lead - Sq)).reshape(
        (B * nblk, bq) + q.shape[2:])
    # the key blocks [a - bq, a + Sp): the first block's previous band
    # padding where it is block 0 (never attended), the tail past Sk too
    lo, hi = max(a - bq, 0), min(a + Sp, Sk)
    front, back = bq - (a - lo), a + Sp - hi
    kp = F.pad(k_pos[:, lo:hi], (front, back), value=big)

    def bands(t):   # (B, (nblk + 1) bq, ...) -> (B*nblk, 2bq, ...)
        tb = t.reshape((B, nblk + 1, bq) + t.shape[2:])
        band = torch.cat([tb[:, :-1], tb[:, 1:]], dim=2)
        return band.reshape((B * nblk, 2 * bq) + t.shape[2:])

    kb, vb = (bands(F.pad(t[:, lo:hi], (0, 0, 0, 0, front, back)))
              for t in (k, v))
    qpb, kpb = qp.reshape(B * nblk, bq), bands(kp)
    outs, lses = [], []
    for c in passes(B * nblk, 4 * H * bq * 2 * bq):   # f32 scores
        mask = make_mask(qpb[c], kpb[c], window=window)
        if n_meta:
            mask = mask & (kpb[c] >= n_meta)[:, None, :]  # meta: its own pass
        o, lse = _sdpa_lse(qb[c], kb[c], vb[c], mask, bf16)
        outs.append(o)
        lses.append(lse)
    out_b = cat(outs, 0).reshape(B, Sp, H, hd)[:, lead:lead + Sq]
    lse_b = cat(lses, 0).reshape(B, Sp, H)[:, lead:lead + Sq]
    if not n_meta:
        return out_b
    # meta keys are visible through the window (sinks); causality still
    # holds for the meta tokens' own queries
    outs, lses = [], []
    for c in passes(Sq, 4 * B * H * n_meta):
        mask_m = (torch.arange(n_meta, device=q.device)[None, None, :]
                  <= pos1d[:, c, None])
        o, lse = _sdpa_lse(q[:, c], k[:, :n_meta], v[:, :n_meta], mask_m,
                           bf16)
        outs.append(o)
        lses.append(lse)
    out_m, lse_m = cat(outs, 1), cat(lses, 1)
    mx = torch.maximum(lse_b, lse_m)
    wb = torch.exp(lse_b - mx)
    wm = torch.exp(lse_m - mx)
    den = wb + wm
    return (out_b * (wb / den)[..., None].to(out_b.dtype)
            + out_m * (wm / den)[..., None].to(out_m.dtype))


def attention_decode_windowed(x: Tensor, p, cfg: ModelConfig,
                              cache: Dict[str, Tensor], positions: Tensor,
                              *, window: int, n_meta: int = 0
                              ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Sliding-window decode that reads only the live window: the cache
    update is ``attention_decode``'s (in place, the whole padded cache
    kept), but the scores cover keys [idx-window+1 .. idx] and the meta
    prefix only. The masked baseline's function; needs Smax >= window."""
    B, _, D = x.shape
    q, k, v, idx = _decode_qkv(x, p, cfg, cache, positions)
    Smax = k.shape[1]
    start = min(max(idx - window + 1, 0), Smax - window)
    k_win, v_win = k[:, start:start + window], v[:, start:start + window]
    kp_win = torch.arange(start, start + window, device=x.device)[None, :]
    mask_win = make_mask(t_stream(positions)[:, -1:], kp_win, window=window)
    if n_meta:
        mask_win = mask_win & (kp_win >= n_meta)[:, None, :]
        kk = torch.cat([k[:, :n_meta], k_win], dim=1)
        vv = torch.cat([v[:, :n_meta], v_win], dim=1)
        mask = torch.cat([torch.ones((B, 1, n_meta), dtype=torch.bool,
                                     device=x.device), mask_win], dim=2)
    else:
        kk, vv, mask = k_win, v_win, mask_win
    out = _sdpa(q, kk, vv, mask, cfg)
    y = torch.matmul(out.reshape(B, 1, cfg.n_heads * cfg.hd), p.wo)
    return y, {"k": k, "v": v, "idx": idx + 1}
