"""The decoder-only causal LM: init, forward, prefill, decode (port of
repro/models/model.py) for the dense, MoE, SSM and hybrid families.

The parameters are ``nn.Module``s that mirror the reference's tree:
``CausalLM`` holds ``embed`` (V, D), ``final_norm``, ``lm_head`` (D, V)
unless the embeddings are tied, ``meta`` (hymba's meta tokens, (M, D))
where the config has them, and ``layers``, one ``Leaves`` node each
with the reference's children of a layer -- ``ln1``, ``ln2``, then by
family ``attn`` (``wq`` (D, H*hd), ``wk``/``wv`` (D, K*hd), ``wo`` (H*hd,
D), the qk-norm scales), ``mlp``, ``moe`` (``router``, the experts'
``w_gate``/``w_up``/``w_down``, ``shared``), ``ssm`` (``in_proj``,
``conv_w``/``conv_b``, ``A_log``, ``D_skip``, ``dt_bias`` (f32),
``norm_scale``, ``out_proj``) and hybrid's branch norms ``bn_attn`` /
``bn_ssm`` -- each layer's slice of the reference's layer-stacked
leaves. Plain functions with the reference's names run them; the
reference's scan over layers (and its per-layer remat) is a loop over
``params.layers``. Parameters carry no gradient: training, with a
backward for the flash kernel, is a later slice.

The reference's default path computes both the full and the windowed
attention of every layer of a windowed model, then selects one; the loop
here computes only the layer's own (``layer_windows``). Its banded
prefill (``ctx.banded``) is the ``banded`` argument of ``prefill`` and
``forward``.

The cache is {"k", "v": (L, B, Smax, K, hd) in the model's dtype, "state":
(L, B, H_ssm, N, P) and "conv": (L, B, k-1, conv_dim) in f32, "idx":
int}, the entries the family has: the reference's layout with the length
a Python int. Decode writes the new entries in place.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .attention import (_project_qkv, arange_positions, attention_decode,
                        self_attend)
from .configs import LATER_FAMILY, ModelConfig
from .layers import mlp, norm
from .moe import moe_ffn
from .ssm import ssd_decode, ssd_forward

Tensor = torch.Tensor
Cache = Dict[str, object]

#: the SSM leaves the reference keeps in f32 whatever the model's dtype
F32_LEAVES = ("A_log", "D_skip", "dt_bias")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if cfg.family in LATER_FAMILY or cfg.encoder_layers or cfg.mrope:
        where = LATER_FAMILY.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family} family): the port runs the dense, "
            f"MoE, SSM and hybrid families; {where} is a later slice of "
            f"the port")
    if cfg.norm != "rmsnorm" or cfg.mlp != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: norm {cfg.norm!r} / mlp {cfg.mlp!r} come with the "
            f"encoder-decoder slice of the port")


# =====================================================================
# parameters
# =====================================================================

def _param(t: Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Leaves(nn.Module):
    """One node of the reference's parameter tree: each tensor of
    ``tree`` a (frozen) parameter, each dict a child node."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        for name, value in tree.items():
            setattr(self, name, Leaves(value) if isinstance(value, dict)
                    else _param(value))


class CausalLM(nn.Module):
    """The LM's parameters; ``forward(tokens)`` runs ``forward`` below."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, object]):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.final_norm = Leaves(tree["final_norm"])
        self.layers = nn.ModuleList(Leaves(t) for t in tree["layers"])
        for name in ("lm_head", "meta"):
            if name in tree:
                setattr(self, name, _param(tree[name]))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: Tensor) -> Tensor:
        return forward(self, {"tokens": tokens}, self.cfg)


def _layer_keys(cfg: ModelConfig) -> List[str]:
    """The children of a layer, as the reference's ``_layer_stack_p``."""
    keys = ["ln1", "ln2"]
    if cfg.has_attention:
        keys.append("attn")
    if cfg.has_ssm:
        keys.append("ssm")
        if cfg.family == "hybrid":
            keys += ["bn_attn", "bn_ssm"]
    if cfg.is_moe:
        keys.append("moe")
    elif cfg.family != "ssm":
        keys.append("mlp")
    return keys


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def from_leaves(cfg: ModelConfig, leaves) -> CausalLM:
    """A CausalLM from the reference's parameter tree of tensors: the
    layer leaves stacked on axis 0 (each layer takes a view of its
    slice)."""
    check_supported(cfg)
    lay = leaves["layers"]
    if sorted(lay) != sorted(_layer_keys(cfg)):
        raise ValueError(f"layers hold {sorted(lay)}, the {cfg.family} "
                         f"family has {sorted(_layer_keys(cfg))}")
    L = cfg.n_layers
    _tree_map(lambda t: _need_layers(t, L), lay)
    tree = {k: v for k, v in leaves.items() if k != "layers"}
    tree["layers"] = [_tree_map(lambda t: t[i], lay) for i in range(L)]
    return CausalLM(cfg, tree)


def _need_layers(t: Tensor, L: int) -> None:
    if t.shape[0] != L:
        raise ValueError(f"a layer leaf of shape {tuple(t.shape)} stacks "
                         f"{t.shape[0]} layers, the config has {L}")


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


def _layer_tree(gen: torch.Generator, cfg: ModelConfig, dev
                ) -> Dict[str, object]:
    """One layer's parameters with the reference's distributions."""
    D, H, K, hd, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)

    def ones(*shape, dtype=None):
        return torch.ones(shape, dtype=dtype or cfg.dtype, device=dev)

    def dense(*shape, scale=None):
        return _dense(gen, shape, cfg, dev, scale)

    def swiglu_p():
        return {"w_gate": dense(D, Fd), "w_up": dense(D, Fd),
                "w_down": dense(Fd, D)}

    t: Dict[str, object] = {"ln1": {"scale": ones(D)},
                            "ln2": {"scale": ones(D)}}
    if cfg.has_attention:
        t["attn"] = {"wq": dense(D, H * hd), "wk": dense(D, K * hd),
                     "wv": dense(D, K * hd), "wo": dense(H * hd, D)}
        if cfg.qk_norm:
            t["attn"].update(q_norm=ones(hd), k_norm=ones(hd))
    if cfg.has_ssm:
        Hs, f32 = cfg.ssm_heads, torch.float32
        proj_out = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + Hs
        u = torch.rand((Hs,), generator=gen, dtype=f32, device=dev)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        t["ssm"] = {
            "in_proj": dense(D, proj_out),
            "conv_w": dense(cfg.conv_dim, cfg.ssm_conv,
                            scale=cfg.ssm_conv ** -0.5),
            "conv_b": torch.zeros(cfg.conv_dim, dtype=cfg.dtype, device=dev),
            "A_log": torch.log(torch.arange(1, Hs + 1, dtype=f32,
                                            device=dev)),
            "D_skip": ones(Hs, dtype=f32),
            "dt_bias": dt + torch.log(-torch.expm1(-dt)),   # inv softplus
            "norm_scale": ones(cfg.d_inner),
            "out_proj": dense(cfg.d_inner, D)}
        if cfg.family == "hybrid":
            t["bn_attn"] = {"scale": ones(D)}
            t["bn_ssm"] = {"scale": ones(D)}
    if cfg.is_moe:
        E = cfg.n_experts
        t["moe"] = {"router": dense(D, E, scale=0.02),
                    "w_gate": dense(E, D, Fd), "w_up": dense(E, D, Fd),
                    "w_down": dense(E, Fd, D)}
        if cfg.shared_expert:
            t["moe"]["shared"] = swiglu_p()
    elif cfg.family != "ssm":
        t["mlp"] = swiglu_p()
    return t


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> CausalLM:
    """Random parameters with the reference's distributions: normal x
    fan_in^-0.5 for the projections and experts, x 0.02 for ``embed``,
    ``lm_head``, the router and the meta tokens, x ssm_conv^-0.5 for the
    conv, ones for the norms, the SSM's A_log, D_skip and dt_bias as the
    reference sets them (f32). ``generator`` must live on ``device``
    (CUDA unless the CPU is asked for); layer by layer, so no f32 copy of
    the whole model is ever held."""
    from ..core.detector import resolve_device
    check_supported(cfg)
    dev = resolve_device(device)
    D, V = cfg.d_model, cfg.vocab
    tree: Dict[str, object] = {
        "embed": _dense(generator, (V, D), cfg, dev, scale=0.02),
        "final_norm": {"scale": torch.ones(D, dtype=cfg.dtype, device=dev)},
        "layers": [_layer_tree(generator, cfg, dev)
                   for _ in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        tree["lm_head"] = _dense(generator, (D, V), cfg, dev, scale=0.02)
    if cfg.meta_tokens:
        tree["meta"] = _dense(generator, (cfg.meta_tokens, D), cfg, dev,
                              scale=0.02)
    return CausalLM(cfg, tree)


# =====================================================================
# blocks
# =====================================================================

def _is_global(layer_idx: int, cfg: ModelConfig) -> bool:
    """Whether a layer attends to every earlier position (no window)."""
    return not cfg.sliding_window or layer_idx in cfg.global_attn_layers


def layer_segments(cfg: ModelConfig) -> List[Tuple[int, int, str]]:
    """Consecutive runs of layers of one attention kind: (first, end,
    "global" or "window")."""
    segs: List[Tuple[int, int, str]] = []
    for li in range(cfg.n_layers):
        kind = "global" if _is_global(li, cfg) else "window"
        if segs and segs[-1][2] == kind:
            segs[-1] = (segs[-1][0], li + 1, kind)
        else:
            segs.append((li, li + 1, kind))
    return segs


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Each layer's attention window: 0 on global layers."""
    return [0 if kind == "global" else cfg.sliding_window
            for a, b, kind in layer_segments(cfg) for _ in range(a, b)]


def _mix(outs: List[Tensor]) -> Tensor:
    """The mixer's output: one branch, or hybrid's two averaged."""
    return 0.5 * (outs[0] + outs[1]) if len(outs) == 2 else outs[0]


def _mixer(h: Tensor, lp, cfg: ModelConfig, pos: Tensor, window: int,
           banded: bool) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]],
                                  Optional[Dict[str, Tensor]]]:
    """The token mixer of one layer over a whole sequence at arange
    positions ``pos``: attention (flash without a window), SSM, or
    hybrid's two in parallel. -> (output, (k, v) or None, the SSM cache
    or None)."""
    B, S, _ = h.shape
    outs, kv, ssm_cache = [], None, None
    if cfg.has_attention:
        q, k, v = _project_qkv(h, lp.attn, cfg, pos)
        a = self_attend(q, k, v, cfg, window=window, n_meta=cfg.meta_tokens,
                        banded=banded)
        a = torch.matmul(a.reshape(B, S, cfg.n_heads * cfg.hd), lp.attn.wo)
        if cfg.family == "hybrid":
            a = norm(a, lp.bn_attn, cfg.norm, cfg.norm_eps)
        outs.append(a)
        kv = (k, v)
    if cfg.has_ssm:
        s, ssm_cache = ssd_forward(h, lp.ssm, cfg)
        if cfg.family == "hybrid":
            s = norm(s, lp.bn_ssm, cfg.norm, cfg.norm_eps)
        outs.append(s)
    return _mix(outs), kv, ssm_cache


def _ffn(x: Tensor, lp, cfg: ModelConfig) -> Tensor:
    if cfg.is_moe:
        return moe_ffn(x, lp.moe, cfg)
    return mlp(x, lp.mlp, cfg.mlp)


def _ffn_residual(x: Tensor, lp, cfg: ModelConfig) -> Tensor:
    """x plus the layer's FFN of its second norm (mamba2 has none)."""
    if cfg.family == "ssm":
        return x
    return x + _ffn(norm(x, lp.ln2, cfg.norm, cfg.norm_eps), lp, cfg)


# =====================================================================
# full model
# =====================================================================

def embed_tokens(params: CausalLM, tokens: Tensor, cfg: ModelConfig
                 ) -> Tensor:
    """Embedding rows times sqrt(d_model), the scale first rounded to the
    config's dtype, as the reference's weak-typed Python float is (71.5
    in bf16 for d_model 5120): the unrounded float would multiply in f32
    and round once, which is another number (215 for 3.0, not 214). The
    exact product of two bf16 values rounds once either way."""
    x = params.embed[tokens].to(cfg.dtype)
    scale = float(torch.tensor(cfg.d_model ** 0.5).to(cfg.dtype))
    return x * scale


def logits_from_hidden(params: CausalLM, x: Tensor, cfg: ModelConfig
                       ) -> Tensor:
    x = norm(x, params.final_norm, cfg.norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return torch.matmul(x, head.to(cfg.dtype))


def _embed_prompt(params: CausalLM, batch: Dict[str, Tensor],
                  cfg: ModelConfig) -> Tensor:
    """The batch's tokens (B, S) embedded, after the meta tokens where the
    config has them -> (B, M + S, D); the positions are arange."""
    if "positions" in batch:
        raise NotImplementedError(
            "explicit positions come with the VLM slice of the port (the "
            "decoder-only families run at arange positions)")
    x = embed_tokens(params, batch["tokens"], cfg)
    if cfg.meta_tokens:
        meta = params.meta.to(cfg.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([meta, x], dim=1)
    return x


def forward(params: CausalLM, batch: Dict[str, Tensor], cfg: ModelConfig,
            banded: bool = False) -> Tensor:
    """Eval forward -> logits (B, S, V). batch: tokens (B, S). ``banded``
    runs windowed layers through ``banded_core``."""
    check_supported(cfg)
    with torch.inference_mode():
        x = _embed_prompt(params, batch, cfg)
        pos = arange_positions(x.shape[0], x.shape[1], x.device)
        for lp, window in zip(params.layers, layer_windows(cfg)):
            h = norm(x, lp.ln1, cfg.norm, cfg.norm_eps)
            x = x + _mixer(h, lp, cfg, pos, window, banded)[0]
            x = _ffn_residual(x, lp, cfg)
        return logits_from_hidden(params, x[:, cfg.meta_tokens:], cfg)


# =====================================================================
# serving: prefill + decode
# =====================================================================

def init_cache(cfg: ModelConfig, B: int, max_len: int,
               device=None) -> Cache:
    """The cache, layer-stacked, zeros, on ``device`` (CUDA unless the CPU
    is asked for): "k", "v" (L, B, max_len + meta, K, hd) in the config's
    dtype where the family attends, "state" (L, B, H_ssm, N, P) and
    "conv" (L, B, k-1, conv_dim) in f32 where it has an SSM; "idx": 0."""
    from ..core.detector import resolve_device
    check_supported(cfg)
    dev = resolve_device(device)
    L = cfg.n_layers
    cache: Cache = {"idx": 0}
    if cfg.has_attention:
        shape = (L, B, max_len + cfg.meta_tokens, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    if cfg.has_ssm:
        f32 = torch.float32
        cache["state"] = torch.zeros(
            (L, B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim), dtype=f32,
            device=dev)
        cache["conv"] = torch.zeros((L, B, cfg.ssm_conv - 1, cfg.conv_dim),
                                    dtype=f32, device=dev)
    return cache


def _decode_layer(x: Tensor, lp, cfg: ModelConfig, cache_l: Cache,
                  positions: Tensor, window: int) -> Tuple[Tensor, Cache]:
    """One block for one token; ``cache_l`` holds this layer's (B, Smax,
    K, hd) k and v (updated in place), its SSM state and conv, and the
    shared idx. -> (x, the new SSM cache entries)."""
    h = norm(x, lp.ln1, cfg.norm, cfg.norm_eps)
    outs, new = [], {}
    if cfg.has_attention:
        a, _ = attention_decode(h, lp.attn, cfg, cache_l, positions,
                                window=window, n_meta=cfg.meta_tokens)
        if cfg.family == "hybrid":
            a = norm(a, lp.bn_attn, cfg.norm, cfg.norm_eps)
        outs.append(a)
    if cfg.has_ssm:
        s, new = ssd_decode(h, lp.ssm, cfg, cache_l)
        if cfg.family == "hybrid":
            s = norm(s, lp.bn_ssm, cfg.norm, cfg.norm_eps)
        outs.append(s)
    return _ffn_residual(x + _mix(outs), lp, cfg), new


def decode_step(params: CausalLM, token: Tensor, cache: Cache,
                cfg: ModelConfig) -> Tuple[Tensor, Cache]:
    """One decode step. token: (B, 1) -> (logits (B, 1, V), cache with
    idx + 1). The cache's tensors are written in place and shared by the
    returned cache."""
    check_supported(cfg)
    with torch.inference_mode():
        B = token.shape[0]
        x = embed_tokens(params, token, cfg)
        idx = cache["idx"]
        positions = torch.full((B, 1), idx, dtype=torch.int32,
                               device=x.device)
        tensors = [t for t in ("k", "v", "state", "conv") if t in cache]
        for li, (lp, window) in enumerate(zip(params.layers,
                                              layer_windows(cfg))):
            cache_l = {t: cache[t][li] for t in tensors}
            x, new = _decode_layer(x, lp, cfg, {**cache_l, "idx": idx},
                                   positions, window)
            for t, value in new.items():
                cache_l[t].copy_(value)
        logits = logits_from_hidden(params, x, cfg)
    return logits, {**{t: cache[t] for t in tensors}, "idx": idx + 1}


def prefill(params: CausalLM, batch: Dict[str, Tensor], cfg: ModelConfig,
            max_len: int, banded: bool = False) -> Tuple[Tensor, Cache]:
    """Prefill: run the whole prompt (batch: tokens (B, S)) after the
    meta tokens, build the cache, return the last position's logits (B,
    1, V). Attention without a window takes the flash kernel; ``banded``
    runs windowed layers through ``banded_core``."""
    check_supported(cfg)
    with torch.inference_mode():
        S = batch["tokens"].shape[1]
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        x = _embed_prompt(params, batch, cfg)
        B, Sm = x.shape[:2]
        pos = arange_positions(B, Sm, x.device)
        cache = init_cache(cfg, B, max_len, x.device)
        for li, (lp, window) in enumerate(zip(params.layers,
                                              layer_windows(cfg))):
            h = norm(x, lp.ln1, cfg.norm, cfg.norm_eps)
            out, kv, ssm_cache = _mixer(h, lp, cfg, pos, window, banded)
            x = _ffn_residual(x + out, lp, cfg)
            if kv is not None:
                cache["k"][li, :, :Sm] = kv[0]
                cache["v"][li, :, :Sm] = kv[1]
            if ssm_cache is not None:
                cache["state"][li] = ssm_cache["state"]
                cache["conv"][li] = ssm_cache["conv"]
        logits = logits_from_hidden(params, x[:, -1:], cfg)
    cache["idx"] = Sm
    return logits, cache
