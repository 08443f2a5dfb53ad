"""The causal LM, dense family: init, forward, prefill, decode (port of
repro/models/model.py).

The parameters are ``nn.Module``s that mirror the reference's tree --
``DenseLM`` holds ``embed`` (V, D), ``final_norm``, ``lm_head`` (D, V)
unless the embeddings are tied, and ``layers``, one ``DecoderLayer``
each (``ln1``, ``attn`` with ``wq`` (D, H*hd), ``wk``/``wv`` (D, K*hd),
``wo`` (H*hd, D) and the qk-norm scales, ``ln2``, ``mlp``) -- with the
reference's shapes, each layer's slice of its layer-stacked leaves.
Plain functions with the reference's names run them; the reference's
scan over layers (and its per-layer remat) is a loop over
``params.layers``. Parameters carry no gradient: training, with a
backward for the flash kernel, is a later slice.

The KV cache is {"k", "v": (L, B, Smax, K, hd), "idx": int}: the
reference's layout, with the length a Python int, and decode writes the
new entries in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .attention import (_project_qkv, arange_positions, attend,
                        attention, attention_decode)
from .configs import LATER_FAMILY, ModelConfig
from .layers import mlp, norm

Tensor = torch.Tensor
Cache = Dict[str, object]

def check_dense(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if cfg.family != "dense" or cfg.is_moe or cfg.encoder_layers \
            or cfg.mrope or cfg.sliding_window or cfg.meta_tokens:
        where = LATER_FAMILY.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family} family): the port runs the dense "
            f"family only; {where} is a later slice of the port")
    if cfg.norm != "rmsnorm" or cfg.mlp != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: norm {cfg.norm!r} / mlp {cfg.mlp!r} come with the "
            f"encoder-decoder slice of the port")


# =====================================================================
# parameters
# =====================================================================

def _param(t: Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Norm(nn.Module):
    def __init__(self, scale: Tensor):
        super().__init__()
        self.scale = _param(scale)


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_param, (wq, wk, wv, wo))
        if q_norm is not None:
            self.q_norm, self.k_norm = _param(q_norm), _param(k_norm)


class MLP(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = map(_param,
                                                  (w_gate, w_up, w_down))


class DecoderLayer(nn.Module):
    def __init__(self, ln1: Norm, attn: Attention, ln2: Norm, mlp_: MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp_


class DenseLM(nn.Module):
    """The dense family's parameters; ``forward(tokens)`` runs
    ``forward`` below."""

    def __init__(self, cfg: ModelConfig, embed: Tensor, final_norm: Norm,
                 layers, lm_head: Optional[Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(embed)
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)
        if lm_head is not None:
            self.lm_head = _param(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: Tensor) -> Tensor:
        return forward(self, {"tokens": tokens}, self.cfg)


def from_leaves(cfg: ModelConfig, leaves) -> DenseLM:
    """A DenseLM from the reference's parameter tree of tensors: the
    layer leaves stacked on axis 0 (each layer takes a view of its
    slice)."""
    check_dense(cfg)
    lay = leaves["layers"]
    L = cfg.n_layers
    for name, t in (("ln1", lay["ln1"]["scale"]),
                    ("wq", lay["attn"]["wq"]), ("w_up", lay["mlp"]["w_up"])):
        if t.shape[0] != L:
            raise ValueError(f"layers.{name} stacks {t.shape[0]} layers, "
                             f"the config has {L}")
    a, m = lay["attn"], lay["mlp"]
    layers = [DecoderLayer(
        Norm(lay["ln1"]["scale"][i]),
        Attention(a["wq"][i], a["wk"][i], a["wv"][i], a["wo"][i],
                  *((a["q_norm"][i], a["k_norm"][i]) if cfg.qk_norm
                    else ())),
        Norm(lay["ln2"]["scale"][i]),
        MLP(m["w_gate"][i], m["w_up"][i], m["w_down"][i]))
        for i in range(L)]
    return DenseLM(cfg, leaves["embed"], Norm(leaves["final_norm"]["scale"]),
                   layers, None if cfg.tie_embeddings else leaves["lm_head"])


# =====================================================================
# init
# =====================================================================

def _dense(gen: torch.Generator, shape, cfg: ModelConfig, device,
           scale: Optional[float] = None) -> Tensor:
    """normal(0, 1) in f32 times fan_in^-0.5 (or ``scale``), cast to the
    config's dtype -- the reference's distribution, not its numbers."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(cfg.dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> DenseLM:
    """Random parameters with the reference's distributions: normal x
    fan_in^-0.5 for the projections, x 0.02 for ``embed`` and
    ``lm_head``, ones for the norms. ``generator`` must live on
    ``device`` (CUDA unless the CPU is asked for); layer by layer, so
    no f32 copy of the whole model is ever held."""
    from ..core.detector import resolve_device
    check_dense(cfg)
    dev = resolve_device(device)
    D, V, H, K, hd, Fd = (cfg.d_model, cfg.vocab, cfg.n_heads,
                          cfg.n_kv_heads, cfg.hd, cfg.d_ff)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=dev)

    embed = _dense(generator, (V, D), cfg, dev, scale=0.02)
    layers = []
    for _ in range(cfg.n_layers):
        attn = Attention(_dense(generator, (D, H * hd), cfg, dev),
                         _dense(generator, (D, K * hd), cfg, dev),
                         _dense(generator, (D, K * hd), cfg, dev),
                         _dense(generator, (H * hd, D), cfg, dev),
                         *((ones(hd), ones(hd)) if cfg.qk_norm else ()))
        mlp_ = MLP(_dense(generator, (D, Fd), cfg, dev),
                   _dense(generator, (D, Fd), cfg, dev),
                   _dense(generator, (Fd, D), cfg, dev))
        layers.append(DecoderLayer(Norm(ones(D)), attn, Norm(ones(D)), mlp_))
    lm_head = None if cfg.tie_embeddings else _dense(
        generator, (D, V), cfg, dev, scale=0.02)
    return DenseLM(cfg, embed, Norm(ones(D)), layers, lm_head)


# =====================================================================
# blocks
# =====================================================================

def _ffn(x: Tensor, lp: DecoderLayer, cfg: ModelConfig) -> Tensor:
    return mlp(x, lp.mlp, cfg.mlp)


def _decoder_layer(x: Tensor, lp: DecoderLayer, cfg: ModelConfig
                   ) -> Tensor:
    """One pre-norm block over a whole sequence at arange positions."""
    h = norm(x, lp.ln1, cfg.norm, cfg.norm_eps)
    x = x + attention(h, lp.attn, cfg)
    h = norm(x, lp.ln2, cfg.norm, cfg.norm_eps)
    return x + _ffn(h, lp, cfg)


# =====================================================================
# full model
# =====================================================================

def embed_tokens(params: DenseLM, tokens: Tensor, cfg: ModelConfig
                 ) -> Tensor:
    """Embedding rows times sqrt(d_model), the scale first rounded to the
    config's dtype, as the reference's weak-typed Python float is (71.5
    in bf16 for d_model 5120): the unrounded float would multiply in f32
    and round once, which is another number (215 for 3.0, not 214). The
    exact product of two bf16 values rounds once either way."""
    x = params.embed[tokens].to(cfg.dtype)
    scale = float(torch.tensor(cfg.d_model ** 0.5).to(cfg.dtype))
    return x * scale


def logits_from_hidden(params: DenseLM, x: Tensor, cfg: ModelConfig
                       ) -> Tensor:
    x = norm(x, params.final_norm, cfg.norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return torch.matmul(x, head.to(cfg.dtype))


def _tokens(batch: Dict[str, Tensor]) -> Tensor:
    """The batch's tokens (B, S); the positions are arange."""
    if "positions" in batch:
        raise NotImplementedError(
            "explicit positions come with the VLM slice of the port (the "
            "dense family runs at arange positions)")
    return batch["tokens"]


def forward(params: DenseLM, batch: Dict[str, Tensor],
            cfg: ModelConfig) -> Tensor:
    """Eval forward -> logits (B, S, V). batch: tokens (B, S)."""
    check_dense(cfg)
    with torch.inference_mode():
        x = embed_tokens(params, _tokens(batch), cfg)
        for lp in params.layers:
            x = _decoder_layer(x, lp, cfg)
        return logits_from_hidden(params, x, cfg)


# =====================================================================
# serving: prefill + decode
# =====================================================================

def init_cache(cfg: ModelConfig, B: int, max_len: int,
               device=None) -> Cache:
    """KV cache, layer-stacked, zeros: {"k", "v": (L, B, max_len, K, hd)
    in the config's dtype, "idx": 0}, on ``device`` (CUDA unless the CPU
    is asked for)."""
    from ..core.detector import resolve_device
    check_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, B, max_len + cfg.meta_tokens, cfg.n_kv_heads,
             cfg.hd)
    return {"idx": 0,
            "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _decode_layer(x: Tensor, lp: DecoderLayer, cfg: ModelConfig,
                  cache_l: Cache, positions: Tensor
                  ) -> Tuple[Tensor, Cache]:
    """One block for one token; ``cache_l`` holds this layer's (B, Smax,
    K, hd) k and v (updated in place) and the shared idx."""
    h = norm(x, lp.ln1, cfg.norm, cfg.norm_eps)
    a, cnew = attention_decode(h, lp.attn, cfg, cache_l, positions)
    x = x + a
    h = norm(x, lp.ln2, cfg.norm, cfg.norm_eps)
    return x + _ffn(h, lp, cfg), cnew


def decode_step(params: DenseLM, token: Tensor, cache: Cache,
                cfg: ModelConfig) -> Tuple[Tensor, Cache]:
    """One decode step. token: (B, 1) -> (logits (B, 1, V), cache with
    idx + 1). The cache's k and v are written in place and shared by the
    returned cache."""
    check_dense(cfg)
    with torch.inference_mode():
        B = token.shape[0]
        x = embed_tokens(params, token, cfg)
        idx = cache["idx"]
        positions = torch.full((B, 1), idx, dtype=torch.int32,
                               device=x.device)
        for li, lp in enumerate(params.layers):
            x, _ = _decode_layer(
                x, lp, cfg, {"k": cache["k"][li], "v": cache["v"][li],
                             "idx": idx}, positions)
        logits = logits_from_hidden(params, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "idx": idx + 1}


def prefill(params: DenseLM, batch: Dict[str, Tensor], cfg: ModelConfig,
            max_len: int) -> Tuple[Tensor, Cache]:
    """Prefill: run the whole prompt (batch: tokens (B, S)), build the
    cache, return the last position's logits (B, 1, V). Attention takes
    the flash kernel."""
    check_dense(cfg)
    with torch.inference_mode():
        tokens = _tokens(batch)
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        x = embed_tokens(params, tokens, cfg)
        pos = arange_positions(B, S, x.device)
        cache = init_cache(cfg, B, max_len, x.device)
        for li, lp in enumerate(params.layers):
            h = norm(x, lp.ln1, cfg.norm, cfg.norm_eps)
            q, k, v = _project_qkv(h, lp.attn, cfg, pos)
            a = attend(q, k, v)
            x = x + torch.matmul(a.reshape(B, S, cfg.n_heads * cfg.hd),
                                 lp.attn.wo)
            cache["k"][li, :, :S] = k
            cache["v"][li, :, :S] = v
            h = norm(x, lp.ln2, cfg.norm, cfg.norm_eps)
            x = x + _ffn(h, lp, cfg)
        logits = logits_from_hidden(params, x[:, -1:], cfg)
    cache["idx"] = S
    return logits, cache
