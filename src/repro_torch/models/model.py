"""The LM: init, forward, loss, prefill, decode (port of
repro/models/model.py) for every family: dense, MoE, SSM, hybrid,
encoder-decoder (whisper) and VLM (qwen2-vl, M-RoPE).

The parameters are ``nn.Module``s that mirror the reference's tree:
``CausalLM`` holds ``embed`` (V, D), ``final_norm``, ``lm_head`` (D, V)
unless the embeddings are tied, ``meta`` (hymba's meta tokens, (M, D))
where the config has them, ``layers``, one ``Leaves`` node each with the
reference's children of a layer -- ``ln1``, ``ln2``, then by family
``attn`` (``wq`` (D, H*hd), ``wk``/``wv`` (D, K*hd), ``wo`` (H*hd, D),
the qk-norm scales), ``mlp`` (swiglu's ``w_gate``/``w_up``/``w_down``,
gelu's ``w_up``/``w_down``), ``moe`` (``router``, the experts'
``w_gate``/``w_up``/``w_down``, ``shared``), ``ssm`` (``in_proj``,
``conv_w``/``conv_b``, ``A_log``, ``D_skip``, ``dt_bias`` (f32),
``norm_scale``, ``out_proj``), hybrid's branch norms ``bn_attn`` /
``bn_ssm`` and the encoder-decoder's cross-attention ``xattn`` and its
norm ``ln_x`` -- and, for the encoder-decoder, ``enc_layers`` (``ln1``,
``ln2``, ``attn``, ``mlp``) and ``enc_norm``. Each norm holds ``scale``,
and ``bias`` for layernorm. Each layer is its slice of the reference's
layer-stacked leaves. Plain functions with the reference's names run
them; the reference's scan over layers is a loop over ``params.layers``.

Serving (``forward``, ``prefill``, ``decode_step``, ``encode``) runs under
``torch.inference_mode`` on frozen parameters. Training takes the same
model made ``trainable`` (every parameter a leaf that takes a gradient)
through ``train_forward`` and ``loss_fn``, the reference's differentiable
forward and next-token loss: each decoder and encoder layer is
recomputed in the backward pass (``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint`` of its scan body), and self-attention
without a window takes the flash kernel through its autograd Function,
whose backward is the hand-written backward kernel.

The reference's default path computes both the full and the windowed
attention of every layer of a windowed model, then selects one; the loop
here computes only the layer's own (``layer_windows``).

``forward``, ``train_forward``, ``loss_fn``, ``prefill`` and
``decode_step`` take the reference's ``ctx`` (models/moe.py:
``ShardingCtx``, from sharding/rules.py:``make_ctx``): the MoE FFN takes
the grid's expert-parallel paths (``moe.moe_path``), and the profile's
attention choices apply (``ctx.banded``: windowed layers through
``banded_core``; ``bf16_scores``, ``flash_vjp``: models/attention.py).
Everything else runs on the parameters' device; the reference's layout
constraints have no counterpart. A layer whose parameters are held as
shards (train/train_step.py's sharded step) gathers them as it runs, and
again in the recompute of the backward.

``batch["positions"]`` ((B, S), or (B, S, 3) for M-RoPE) moves to the
card once; its host copy decides whether the causal mask is
index-causal, and so whether prefill attention takes the flash kernel
(``attention.index_causal``). Whisper's encoder runs once per
``encode``; its states feed every decoder layer's cross-attention, whose
keys and values are recomputed from them in every layer and at every
decode step, as the reference does (there is no cross-KV cache).

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
from torch.utils.checkpoint import checkpoint

from .attention import (_project_qkv, arange_positions, attention,
                        attention_decode, cross_attention, index_causal,
                        self_attend, t_stream)
from .configs import ModelConfig
from .layers import mlp, norm, sinusoidal_positions
from .moe import moe_ffn
from .ssm import ssd_decode, ssd_forward

Tensor = torch.Tensor
Cache = Dict[str, object]

#: the SSM leaves the reference keeps in f32 whatever the model's dtype
F32_LEAVES = ("A_log", "D_skip", "dt_bias")


#: the families of the reference, every one of which the port runs
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
#: whisper's decoder positions: the rows of the reference's table
#: (``decode_step`` reads row idx, clamped to the last)
DECODER_PE_ROWS = 32768 + 8


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for a config no path runs: an unknown family,
    norm or MLP kind."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.norm not in ("rmsnorm", "layernorm") \
            or cfg.mlp not in ("swiglu", "gelu"):
        raise ValueError(f"{cfg.name}: unknown norm {cfg.norm!r} or mlp "
                         f"{cfg.mlp!r}")


# =====================================================================
# parameters
# =====================================================================

def _param(t: Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def trainable(params: "CausalLM") -> "CausalLM":
    """``params`` with every parameter taking a gradient (in place), for
    training; serving keeps them frozen."""
    for t in params.parameters():
        t.requires_grad_(True)
    return params


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
        if "enc_layers" in tree:
            self.enc_layers = nn.ModuleList(Leaves(t)
                                            for t in tree["enc_layers"])
            self.enc_norm = Leaves(tree["enc_norm"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: Tensor) -> Tensor:
        return forward(self, {"tokens": tokens}, self.cfg)


def _layer_keys(cfg: ModelConfig) -> List[str]:
    """The children of a decoder layer, as the reference's
    ``_layer_stack_p``; an encoder layer's are ln1, ln2, attn, mlp."""
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
    if cfg.encoder_layers:
        keys += ["xattn", "ln_x"]
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
    tree = {k: v for k, v in leaves.items()
            if k not in ("layers", "enc_layers")}
    tree["layers"] = _unstack(lay, cfg.n_layers)
    if cfg.encoder_layers:
        enc = leaves["enc_layers"]
        if sorted(enc) != ["attn", "ln1", "ln2", "mlp"]:
            raise ValueError(f"enc_layers hold {sorted(enc)}, the encoder "
                             f"has attn, ln1, ln2, mlp")
        tree["enc_layers"] = _unstack(enc, cfg.encoder_layers)
    return CausalLM(cfg, tree)


def _unstack(lay, L: int) -> List[Dict[str, object]]:
    """Layer-stacked leaves -> one tree of views a layer."""
    _tree_map(lambda t: _need_layers(t, L), lay)
    return [_tree_map(lambda t: t[i], lay) for i in range(L)]


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


def _norm_tree(cfg: ModelConfig, dev) -> Dict[str, Tensor]:
    """A norm's weights: scale ones, and bias zeros for layernorm."""
    t = {"scale": torch.ones(cfg.d_model, dtype=cfg.dtype, device=dev)}
    if cfg.norm == "layernorm":
        t["bias"] = torch.zeros(cfg.d_model, dtype=cfg.dtype, device=dev)
    return t


def _layer_tree(gen: torch.Generator, cfg: ModelConfig, dev,
                encoder: bool = False) -> Dict[str, object]:
    """One layer's parameters with the reference's distributions (an
    encoder layer's with ``encoder``)."""
    D, H, K, hd, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)

    def ones(*shape, dtype=None):
        return torch.ones(shape, dtype=dtype or cfg.dtype, device=dev)

    def dense(*shape, scale=None):
        return _dense(gen, shape, cfg, dev, scale)

    def mlp_p():
        if cfg.mlp == "gelu":
            return {"w_up": dense(D, Fd), "w_down": dense(Fd, D)}
        return {"w_gate": dense(D, Fd), "w_up": dense(D, Fd),
                "w_down": dense(Fd, D)}

    def attn_p():
        a = {"wq": dense(D, H * hd), "wk": dense(D, K * hd),
             "wv": dense(D, K * hd), "wo": dense(H * hd, D)}
        if cfg.qk_norm:
            a.update(q_norm=ones(hd), k_norm=ones(hd))
        return a

    t: Dict[str, object] = {"ln1": _norm_tree(cfg, dev),
                            "ln2": _norm_tree(cfg, dev)}
    if encoder:
        t.update(attn=attn_p(), mlp=mlp_p())
        return t
    if cfg.has_attention:
        t["attn"] = attn_p()
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
            t["bn_attn"] = _norm_tree(cfg, dev)
            t["bn_ssm"] = _norm_tree(cfg, dev)
    if cfg.is_moe:
        E = cfg.n_experts
        t["moe"] = {"router": dense(D, E, scale=0.02),
                    "w_gate": dense(E, D, Fd), "w_up": dense(E, D, Fd),
                    "w_down": dense(E, Fd, D)}
        if cfg.shared_expert:
            t["moe"]["shared"] = mlp_p()
    elif cfg.family != "ssm":
        t["mlp"] = mlp_p()
    if cfg.encoder_layers:
        t["xattn"] = attn_p()
        t["ln_x"] = _norm_tree(cfg, dev)
    return t


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> CausalLM:
    """Random parameters with the reference's distributions: normal x
    fan_in^-0.5 for the projections and experts, x 0.02 for ``embed``,
    ``lm_head``, the router and the meta tokens, x ssm_conv^-0.5 for the
    conv, ones for the norm scales and zeros for layernorm's biases, the
    SSM's A_log, D_skip and dt_bias as the reference sets them (f32); the
    encoder-decoder's encoder layers and cross-attention likewise.
    ``generator`` must live on ``device``
    (CUDA unless the CPU is asked for); layer by layer, so no f32 copy of
    the whole model is ever held."""
    from ..core.detector import resolve_device
    check_supported(cfg)
    return CausalLM(cfg, _init_tree(cfg, generator, resolve_device(device)))


def param_shapes(cfg: ModelConfig) -> Dict[str, Tensor]:
    """``init_params``' parameters by name as meta tensors: their shapes
    and dtypes, nothing allocated (sharding plans of full-size models)."""
    check_supported(cfg)
    tree = _init_tree(cfg, torch.Generator(), torch.device("meta"))
    return dict(CausalLM(cfg, tree).named_parameters())


def _init_tree(cfg: ModelConfig, generator: torch.Generator, dev
               ) -> Dict[str, object]:
    D, V = cfg.d_model, cfg.vocab
    tree: Dict[str, object] = {
        "embed": _dense(generator, (V, D), cfg, dev, scale=0.02),
        "final_norm": _norm_tree(cfg, dev),
        "layers": [_layer_tree(generator, cfg, dev)
                   for _ in range(cfg.n_layers)]}
    if cfg.encoder_layers:
        tree["enc_layers"] = [_layer_tree(generator, cfg, dev, encoder=True)
                              for _ in range(cfg.encoder_layers)]
        tree["enc_norm"] = _norm_tree(cfg, dev)
    if not cfg.tie_embeddings:
        tree["lm_head"] = _dense(generator, (D, V), cfg, dev, scale=0.02)
    if cfg.meta_tokens:
        tree["meta"] = _dense(generator, (cfg.meta_tokens, D), cfg, dev,
                              scale=0.02)
    return tree


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
           ctx, flash: bool
           ) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]],
                      Optional[Dict[str, Tensor]]]:
    """The token mixer of one layer over a whole sequence at positions
    ``pos`` ((B, S) or (B, S, 3)): attention (flash without a window
    where ``flash``: the mask is index-causal), SSM, or hybrid's two in
    parallel. -> (output, (k, v) or None, the SSM cache or None)."""
    B, S, _ = h.shape
    outs, kv, ssm_cache = [], None, None
    if cfg.has_attention:
        q, k, v = _project_qkv(h, lp.attn, cfg, pos)
        a = self_attend(q, k, v, cfg, t_stream(pos), window=window,
                        n_meta=cfg.meta_tokens, ctx=ctx, flash=flash)
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


def _ffn(x: Tensor, lp, cfg: ModelConfig, ctx=None) -> Tensor:
    if cfg.is_moe:
        return moe_ffn(x, lp.moe, cfg, ctx)
    return mlp(x, lp.mlp, cfg.mlp)


def _cross_and_ffn(x: Tensor, lp, cfg: ModelConfig,
                   enc: Optional[Tensor], ctx=None) -> Tensor:
    """The rest of a decoder layer after its mixer's residual: the
    cross-attention over the encoder states ``enc`` where given, then the
    FFN of the second norm (mamba2 has none), each a residual."""
    if enc is not None:
        h = norm(x, lp.ln_x, cfg.norm, cfg.norm_eps)
        x = x + cross_attention(h, enc, lp.xattn, cfg)
    if cfg.family == "ssm":
        return x
    return x + _ffn(norm(x, lp.ln2, cfg.norm, cfg.norm_eps), lp, cfg, ctx)


def _layer(x: Tensor, lp, cfg: ModelConfig, pos: Tensor, window: int,
           ctx, flash: bool, enc: Optional[Tensor]):
    """One decoder layer over a whole sequence -> (x, (k, v) or None, the
    SSM cache or None)."""
    h = norm(x, lp.ln1, cfg.norm, cfg.norm_eps)
    out, kv, ssm_cache = _mixer(h, lp, cfg, pos, window, ctx, flash)
    return _cross_and_ffn(x + out, lp, cfg, enc, ctx), kv, ssm_cache


class ShardedLeaves:
    """A layer's parameters held as shards (train/train_step.py's sharded
    step): ``gather()`` reads them whole onto the computing device."""

    def gather(self):
        raise NotImplementedError


def _gathered(lp):
    """A layer's parameters: ``lp`` itself, or, where it is held as
    shards, gathered onto the computing device now."""
    return lp.gather() if isinstance(lp, ShardedLeaves) else lp


def _layer_x(x: Tensor, lp, *args) -> Tensor:
    return _layer(x, _gathered(lp), *args)[0]


def _enc_layer(x: Tensor, lp, cfg: ModelConfig) -> Tensor:
    """One encoder layer: attention with every key visible (flash,
    ``causal=False``), then the MLP, each after its norm."""
    lp = _gathered(lp)
    h = norm(x, lp.ln1, cfg.norm, cfg.norm_eps)
    x = x + attention(h, lp.attn, cfg, causal=False)
    h = norm(x, lp.ln2, cfg.norm, cfg.norm_eps)
    return x + mlp(h, lp.mlp, cfg.mlp)


def _remat(fn, *args) -> Tensor:
    """``fn(*args)``, recomputed in the backward pass where grad is
    enabled (the reference's per-layer ``jax.checkpoint``): only the
    layer's input is kept for the backward. A layer held as shards may
    span several cards; it takes the reentrant form, which recomputes it
    once, in the backward of its output, before the inner backward fans
    out over the cards (the other form recomputes from whichever card's
    node asks first, and two cards' engine threads can ask at once)."""
    if torch.is_grad_enabled():
        reentrant = any(isinstance(a, ShardedLeaves) for a in args)
        if reentrant and not any(isinstance(a, Tensor) and a.requires_grad
                                 for a in args):
            # the reentrant form differentiates only through its tensor
            # inputs: where none needs a gradient (whisper's encoder over
            # its frames) the parameters gathered inside would get none
            args = (args[0].detach().requires_grad_(),) + args[1:]
        return checkpoint(fn, *args, use_reentrant=reentrant)
    return fn(*args)


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
                  cfg: ModelConfig) -> Tuple[Tensor, Tensor, bool]:
    """The batch's tokens (B, S) embedded (plus whisper's sinusoidal
    positions), after the meta tokens where the config has them -> (x
    (B, M + S, D), positions on x's device, whether their causal mask is
    index-causal). The positions are ``batch["positions"]`` ((B, S), or
    (B, S, 3) for M-RoPE, required there; numpy or a tensor; the meta
    tokens' arange before them shifted by M) or arange; a host copy
    decides the flash route (``attention.index_causal``), and moves to
    the card once."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    if cfg.encoder_layers and not cfg.mrope:
        x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(
            cfg.dtype)[None]
    pos = batch.get("positions")
    if pos is not None:
        pos = torch.as_tensor(pos)
        shapes = [(B, S, 3)] if cfg.mrope else [(B, S), (B, S, 3)]
        if tuple(pos.shape) not in shapes:
            raise ValueError(f"{cfg.name}: positions of shape "
                             f"{tuple(pos.shape)}, want one of {shapes}")
    elif cfg.mrope:
        raise ValueError(f"{cfg.name} (M-RoPE) takes (B, S, 3) (t, h, w) "
                         f"positions in batch['positions']")
    M = cfg.meta_tokens
    if M:
        meta = params.meta.to(cfg.dtype).expand(B, -1, -1)
        x = torch.cat([meta, x], dim=1)
        if pos is not None:
            if pos.dim() != 2:
                raise ValueError("meta tokens take (B, S) positions")
            pos = torch.cat([torch.arange(M, device=pos.device).expand(B, M),
                             pos + M], dim=1)
    flash = index_causal(pos)
    pos = arange_positions(B, M + S, x.device) if pos is None \
        else pos.to(x.device)
    return x, pos, flash


def _enc_states(params: CausalLM, batch: Dict[str, Tensor],
                cfg: ModelConfig, enc: Optional[Tensor]) -> Optional[Tensor]:
    """The encoder states the decoder attends to: ``enc`` if given (in
    the model's dtype), else the encoder over ``batch["enc_input"]``;
    None without an encoder."""
    if not cfg.encoder_layers:
        return None
    if enc is not None:
        return enc.to(device=params.device, dtype=cfg.dtype)
    if batch.get("enc_input") is None:
        raise ValueError(f"{cfg.name} (encoder-decoder) needs "
                         f"batch['enc_input'] (B, T_enc, d_model)")
    return _encoder(params, batch["enc_input"], cfg)


def _encoder(params: CausalLM, enc_input, cfg: ModelConfig) -> Tensor:
    x = torch.as_tensor(enc_input).to(device=params.device, dtype=cfg.dtype)
    T, D = x.shape[1:]
    x = x + sinusoidal_positions(T, D, x.device).to(cfg.dtype)
    for lp in params.enc_layers:
        x = _remat(_enc_layer, x, lp, cfg)
    return norm(x, params.enc_norm, cfg.norm, cfg.norm_eps)


def encode(params: CausalLM, enc_input, cfg: ModelConfig) -> Tensor:
    """Whisper's encoder: (B, T, D) stub frame embeddings (numpy or a
    tensor) plus the sinusoidal positions, in the model's dtype, through
    the encoder layers -- attention with every key visible (flash,
    ``causal=False``; RoPE at arange positions, as the reference's
    encoder applies it), then the gelu MLP, each after its layernorm --
    and the final ``enc_norm`` -> states (B, T, D)."""
    check_supported(cfg)
    with torch.inference_mode():
        return _encoder(params, enc_input, cfg)


def train_forward(params: CausalLM, batch: Dict[str, Tensor],
                  cfg: ModelConfig, ctx=None) -> Tensor:
    """The reference's differentiable forward (repro/models/model.py:315)
    -> logits (B, S, V), the batch as ``forward`` takes it, with no
    inference mode: where grad is enabled every decoder and encoder layer
    is recomputed in the backward pass (only its input is kept), as the
    reference's remat'd scan."""
    check_supported(cfg)
    x, pos, flash = _embed_prompt(params, batch, cfg)
    enc = _enc_states(params, batch, cfg, None)
    for lp, window in zip(params.layers, layer_windows(cfg)):
        x = _remat(_layer_x, x, lp, cfg, pos, window, ctx, flash, enc)
    return logits_from_hidden(params, x[:, cfg.meta_tokens:], cfg)


def forward(params: CausalLM, batch: Dict[str, Tensor], cfg: ModelConfig,
            ctx=None) -> Tensor:
    """Eval forward -> logits (B, S, V). batch: tokens (B, S) [+
    positions (B, S) or (B, S, 3) for M-RoPE] [+ enc_input (B, T_enc,
    D) for the encoder-decoder]."""
    with torch.inference_mode():
        return train_forward(params, batch, cfg, ctx)


def nll_sum(params: CausalLM, batch: Dict[str, Tensor], cfg: ModelConfig,
            ctx=None) -> Tuple[Tensor, Tensor]:
    """The next-token cross-entropy's numerator and count: the sum over
    the valid positions of logsumexp - the gold logit of
    ``train_forward``'s logits in f32, and how many positions are valid
    (labels of -100, any negative, ignored)."""
    logits = train_forward(params, batch, cfg, ctx).to(torch.float32)
    labels = torch.as_tensor(batch["labels"]).to(logits.device)
    valid = labels >= 0
    labels_c = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


def loss_fn(params: CausalLM, batch: Dict[str, Tensor],
            cfg: ModelConfig, ctx=None) -> Tensor:
    """Next-token cross-entropy against ``batch["labels"]`` (B, S): the
    mean over the valid positions (divided by at least 1), as
    repro/models/model.py:347."""
    nll, count = nll_sum(params, batch, cfg, ctx)
    return nll / torch.clamp(count, min=1)


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


def decoder_pe(idx: int, d: int, device) -> Tensor:
    """Whisper's decoder position embedding of a decode step: row ``idx``
    of the reference's ``sinusoidal_positions(32776, d)`` table (clamped
    to its last row, as its dynamic slice is), (1, d) f32."""
    return sinusoidal_positions(1, d, device,
                                start=min(idx, DECODER_PE_ROWS - 1))


def _decode_layer(x: Tensor, lp, cfg: ModelConfig, cache_l: Cache,
                  positions: Tensor, window: int,
                  enc: Optional[Tensor] = None, ctx=None
                  ) -> Tuple[Tensor, Cache]:
    """One block for one token; ``cache_l`` holds this layer's (B, Smax,
    K, hd) k and v (updated in place), its SSM state and conv, and the
    shared idx; ``enc`` the encoder states its cross-attention reads. ->
    (x, the new SSM cache entries)."""
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
    return _cross_and_ffn(x + _mix(outs), lp, cfg, enc, ctx), new


def decode_step(params: CausalLM, token: Tensor, cache: Cache,
                cfg: ModelConfig, enc: Optional[Tensor] = None, ctx=None
                ) -> Tuple[Tensor, Cache]:
    """One decode step. token: (B, 1) -> (logits (B, 1, V), cache with
    idx + 1). The token sits at position idx (on all three M-RoPE
    streams; whisper adds row idx of its sinusoidal table); ``enc``,
    whisper's encoder states, feeds every layer's cross-attention (none
    without it, as in the reference). The cache's tensors are written in
    place and shared by the returned cache."""
    check_supported(cfg)
    with torch.inference_mode():
        B = token.shape[0]
        x = embed_tokens(params, token, cfg)
        idx = cache["idx"]
        if enc is not None:
            enc = enc.to(device=x.device, dtype=cfg.dtype)
        if cfg.encoder_layers:
            x = x + decoder_pe(idx, cfg.d_model, x.device).to(cfg.dtype)
        positions = torch.full((B, 1, 3) if cfg.mrope else (B, 1), idx,
                               dtype=torch.int32, device=x.device)
        tensors = [t for t in ("k", "v", "state", "conv") if t in cache]
        for li, (lp, window) in enumerate(zip(params.layers,
                                              layer_windows(cfg))):
            cache_l = {t: cache[t][li] for t in tensors}
            x, new = _decode_layer(x, lp, cfg, {**cache_l, "idx": idx},
                                   positions, window, enc, ctx)
            for t, value in new.items():
                cache_l[t].copy_(value)
        logits = logits_from_hidden(params, x, cfg)
    return logits, {**{t: cache[t] for t in tensors}, "idx": idx + 1}


def prefill(params: CausalLM, batch: Dict[str, Tensor], cfg: ModelConfig,
            max_len: int, ctx=None,
            enc: Optional[Tensor] = None) -> Tuple[Tensor, Cache]:
    """Prefill: run the whole prompt (batch: tokens (B, S) [+ positions
    (B, S) or (B, S, 3) for M-RoPE] [+ enc_input for the
    encoder-decoder]) after the meta tokens, build the cache, return the
    last position's logits (B, 1, V). Attention without a window whose
    mask is index-causal takes the flash kernel. ``enc``: the encoder
    states, if already computed (then ``enc_input`` is not read)."""
    check_supported(cfg)
    with torch.inference_mode():
        S = batch["tokens"].shape[1]
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        x, pos, flash = _embed_prompt(params, batch, cfg)
        enc = _enc_states(params, batch, cfg, enc)
        B, Sm = x.shape[:2]
        cache = init_cache(cfg, B, max_len, x.device)
        for li, (lp, window) in enumerate(zip(params.layers,
                                              layer_windows(cfg))):
            x, kv, ssm_cache = _layer(x, lp, cfg, pos, window, ctx, flash,
                                      enc)
            if kv is not None:
                cache["k"][li, :, :Sm] = kv[0]
                cache["v"][li, :, :Sm] = kv[1]
            if ssm_cache is not None:
                cache["state"][li] = ssm_cache["state"]
                cache["conv"][li] = ssm_cache["conv"]
        logits = logits_from_hidden(params, x[:, -1:], cfg)
    cache["idx"] = Sm
    return logits, cache
