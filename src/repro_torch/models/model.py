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
again in the recompute of the backward. ``prefill``, ``decode_step`` and
``encode`` also take a model held as shards (models/sharded.py:
``ShardedLM``, from ``init_params(..., shardings=)``): the batch runs
over ``ctx``'s dp rows, each row on its first device, each layer
gathered onto it as the layer runs (a MoE's expert groups on the row's
devices of each model index); there is no tensor-parallel matmul and no
cache length over "model": each row computes whole layers.

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
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import (_project_qkv, arange_positions, attention,
                        attention_decode, cross_attention, index_causal,
                        self_attend, t_stream)
from .configs import ModelConfig
from .layers import mlp, norm, sinusoidal_positions
from .moe import moe_ffn
from .sharded import (ShardedLeaves, ShardedLM, as_sharded, gathered_rows,
                      row_model, row_plans, shard_leaf)
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
    return x.mul_(std).to(cfg.dtype)


def _norm_leaves(cfg: ModelConfig, dev, prefix: str):
    """A norm's weights: scale ones, and bias zeros for layernorm."""
    yield f"{prefix}.scale", torch.ones(cfg.d_model, dtype=cfg.dtype,
                                        device=dev)
    if cfg.norm == "layernorm":
        yield f"{prefix}.bias", torch.zeros(cfg.d_model, dtype=cfg.dtype,
                                            device=dev)


def _layer_leaves(gen: torch.Generator, cfg: ModelConfig, dev,
                  encoder: bool = False) -> Iterator[Tuple[str, Tensor]]:
    """One layer's parameters with the reference's distributions (an
    encoder layer's with ``encoder``): (path, tensor) in draw order, the
    order of the layer's children."""
    D, H, K, hd, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)

    def ones(*shape, dtype=None):
        return torch.ones(shape, dtype=dtype or cfg.dtype, device=dev)

    def dense(*shape, scale=None):
        return _dense(gen, shape, cfg, dev, scale)

    def mlp_p(at):
        if cfg.mlp == "swiglu":
            yield f"{at}.w_gate", dense(D, Fd)
        yield f"{at}.w_up", dense(D, Fd)
        yield f"{at}.w_down", dense(Fd, D)

    def attn_p(at):
        yield f"{at}.wq", dense(D, H * hd)
        yield f"{at}.wk", dense(D, K * hd)
        yield f"{at}.wv", dense(D, K * hd)
        yield f"{at}.wo", dense(H * hd, D)
        if cfg.qk_norm:
            yield f"{at}.q_norm", ones(hd)
            yield f"{at}.k_norm", ones(hd)

    yield from _norm_leaves(cfg, dev, "ln1")
    yield from _norm_leaves(cfg, dev, "ln2")
    if encoder:
        yield from attn_p("attn")
        yield from mlp_p("mlp")
        return
    if cfg.has_attention:
        yield from attn_p("attn")
    if cfg.has_ssm:
        Hs, f32 = cfg.ssm_heads, torch.float32
        proj_out = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + Hs
        u = torch.rand((Hs,), generator=gen, dtype=f32, device=dev)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        yield "ssm.in_proj", dense(D, proj_out)
        yield "ssm.conv_w", dense(cfg.conv_dim, cfg.ssm_conv,
                                  scale=cfg.ssm_conv ** -0.5)
        yield "ssm.conv_b", torch.zeros(cfg.conv_dim, dtype=cfg.dtype,
                                        device=dev)
        yield "ssm.A_log", torch.log(torch.arange(1, Hs + 1, dtype=f32,
                                                  device=dev))
        yield "ssm.D_skip", ones(Hs, dtype=f32)
        yield "ssm.dt_bias", dt + torch.log(-torch.expm1(-dt))  # inv softplus
        yield "ssm.norm_scale", ones(cfg.d_inner)
        yield "ssm.out_proj", dense(cfg.d_inner, D)
        if cfg.family == "hybrid":
            yield from _norm_leaves(cfg, dev, "bn_attn")
            yield from _norm_leaves(cfg, dev, "bn_ssm")
    if cfg.is_moe:
        E = cfg.n_experts
        yield "moe.router", dense(D, E, scale=0.02)
        yield "moe.w_gate", dense(E, D, Fd)
        yield "moe.w_up", dense(E, D, Fd)
        yield "moe.w_down", dense(E, Fd, D)
        if cfg.shared_expert:
            yield from mlp_p("moe.shared")
    elif cfg.family != "ssm":
        yield from mlp_p("mlp")
    if cfg.encoder_layers:
        yield from attn_p("xattn")
        yield from _norm_leaves(cfg, dev, "ln_x")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, shardings=None):
    """Random parameters with the reference's distributions: normal x
    fan_in^-0.5 for the projections and experts, x 0.02 for ``embed``,
    ``lm_head``, the router and the meta tokens, x ssm_conv^-0.5 for the
    conv, ones for the norm scales and zeros for layernorm's biases, the
    SSM's A_log, D_skip and dt_bias as the reference sets them (f32); the
    encoder-decoder's encoder layers and cross-attention likewise.
    ``generator`` must live on ``device``
    (CUDA unless the CPU is asked for); leaf by leaf, so no f32 copy of
    the whole model is ever held.

    ``shardings`` ({name: Sharding}, sharding/rules.py:
    ``param_shardings``): a ``ShardedLM`` instead -- each leaf drawn whole
    on ``device`` in the same order, cut into its pieces, each placed on
    its grid device, and dropped before the next is drawn; every piece
    equal, bit for bit, to ``Sharding.shard`` of the same leaf of the
    whole model, and no device holding more than its pieces and one
    leaf's draw."""
    from ..core.detector import resolve_device
    check_supported(cfg)
    leaves = _init_leaves(cfg, generator, resolve_device(device))
    if shardings is None:
        return CausalLM(cfg, _nest(leaves))
    pieces = {}
    for name, t in leaves:
        pieces[name] = shard_leaf(shardings[name], t)
        del t
    return ShardedLM(cfg, shardings, pieces)


def param_shapes(cfg: ModelConfig) -> Dict[str, Tensor]:
    """``init_params``' parameters by name as meta tensors: their shapes
    and dtypes, nothing allocated (sharding plans of full-size models)."""
    check_supported(cfg)
    tree = _nest(_init_leaves(cfg, torch.Generator(), torch.device("meta")))
    return dict(CausalLM(cfg, tree).named_parameters())


def _init_leaves(cfg: ModelConfig, generator: torch.Generator, dev
                 ) -> Iterator[Tuple[str, Tensor]]:
    """Every parameter as (name, tensor) in draw order, named as
    ``CausalLM.named_parameters()`` names it."""
    D, V = cfg.d_model, cfg.vocab
    yield "embed", _dense(generator, (V, D), cfg, dev, scale=0.02)
    yield from _norm_leaves(cfg, dev, "final_norm")
    for i in range(cfg.n_layers):
        for path, t in _layer_leaves(generator, cfg, dev):
            yield f"layers.{i}.{path}", t
    if cfg.encoder_layers:
        for i in range(cfg.encoder_layers):
            for path, t in _layer_leaves(generator, cfg, dev, encoder=True):
                yield f"enc_layers.{i}.{path}", t
        yield from _norm_leaves(cfg, dev, "enc_norm")
    if not cfg.tie_embeddings:
        yield "lm_head", _dense(generator, (D, V), cfg, dev, scale=0.02)
    if cfg.meta_tokens:
        yield "meta", _dense(generator, (cfg.meta_tokens, D), cfg, dev,
                             scale=0.02)


def _nest(named: Iterable[Tuple[str, Tensor]]) -> Dict[str, object]:
    """(name, tensor) pairs as the tree ``CausalLM`` takes: "layers.3.attn.wq"
    at tree["layers"][3]["attn"]["wq"]."""
    tree: Dict[str, object] = {}
    for name, t in named:
        node = tree
        *dirs, leaf = name.split(".")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = t
    for k in ("layers", "enc_layers"):
        if k in tree:
            tree[k] = [tree[k][str(i)] for i in range(len(tree[k]))]
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
    return _encoder_rows([params], [enc_input], cfg)[0]


def _encoder_rows(rows, inputs, cfg: ModelConfig,
                  serving: bool = False) -> List[Tensor]:
    """The encoder over each row's frames, on the row's device, layer by
    layer with the rows inner; ``serving``: each layer gathered for every
    row before any runs it (``gathered_rows``), where the trainer's rows
    gather it inside the recomputed block instead."""
    xs = []
    for row, enc_input in zip(rows, inputs):
        x = torch.as_tensor(enc_input).to(device=row.device, dtype=cfg.dtype)
        T, D = x.shape[1:]
        xs.append(x + sinusoidal_positions(T, D, x.device).to(cfg.dtype))
    for lps in zip(*(row.enc_layers for row in rows)):
        if serving:
            lps = gathered_rows(lps)
        xs = [_remat(_enc_layer, x, lp, cfg) for x, lp in zip(xs, lps)]
    return [norm(x, row.enc_norm, cfg.norm, cfg.norm_eps)
            for row, x in zip(rows, xs)]


def encode(params, enc_input, cfg: ModelConfig, ctx=None) -> Tensor:
    """Whisper's encoder: (B, T, D) stub frame embeddings (numpy or a
    tensor) plus the sinusoidal positions, in the model's dtype, through
    the encoder layers -- attention with every key visible (flash,
    ``causal=False``; RoPE at arange positions, as the reference's
    encoder applies it), then the gelu MLP, each after its layernorm --
    and the final ``enc_norm`` -> states (B, T, D). A model held as
    shards (``ShardedLM``) runs its batch over ``ctx``'s dp rows, as
    ``prefill`` does; the states return on the grid's first device in
    row order."""
    check_supported(cfg)
    model = as_sharded(params, cfg, ctx)
    with torch.inference_mode():
        if model is None:
            return _encoder(params, enc_input, cfg)
        rows, _ = _sharded_rows(model, cfg, ctx, len(enc_input))
        states = _encoder_rows(rows, _split_rows(enc_input, len(rows)), cfg,
                               serving=True)
        return _on_first(states, model.device)


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


# --------------------------------------------- a model held as shards

def _sharded_rows(model: ShardedLM, cfg: ModelConfig, ctx, B: int):
    """The dp rows a batch of B runs over (``ctx``, by default
    ``make_ctx`` of the model's grid) -> (each row's model, each row's
    context); ValueError unless B splits over them."""
    if ctx is None:
        from ..sharding.rules import make_ctx
        ctx = make_ctx(model.grid)
    plans = row_plans(ctx)
    if B % len(plans):
        raise ValueError(f"a batch of {B} rows does not split over the "
                         f"grid's {len(plans)} dp rows")
    memo: Dict = {}
    return ([row_model(cfg, model.pieces, model.shardings, p, True, memo)
             for p in plans], [p.ctx for p in plans])


def _split_rows(x, n: int) -> list:
    """x (numpy or a tensor; None passes) cut into n equal runs of rows."""
    if x is None:
        return [None] * n
    if len(x) % n:
        raise ValueError(f"{len(x)} rows do not split over {n} dp rows")
    b = len(x) // n
    return [x[i * b:(i + 1) * b] for i in range(n)]


def _row_batches(batch: Dict[str, Tensor], rows) -> List[Dict[str, Tensor]]:
    """The batch's rows for each dp row, the tokens on the row's device
    (``positions`` stay where they are: a host copy picks the flash
    route)."""
    cut = {k: _split_rows(v, len(rows)) for k, v in batch.items()
           if v is not None}
    return [{k: (torch.as_tensor(v[r]).to(row.device) if k == "tokens"
                 else v[r]) for k, v in cut.items()}
            for r, row in enumerate(rows)]


def _on_first(parts: List[Tensor], device) -> Tensor:
    """The rows' results, in row order, on the grid's first device."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], 0)


def decode_step(params, token: Tensor, cache: Cache,
                cfg: ModelConfig, enc: Optional[Tensor] = None, ctx=None
                ) -> Tuple[Tensor, Cache]:
    """One decode step. token: (B, 1) -> (logits (B, 1, V), cache with
    idx + 1). The token sits at position idx (on all three M-RoPE
    streams; whisper adds row idx of its sinusoidal table); ``enc``,
    whisper's encoder states, feeds every layer's cross-attention (none
    without it, as in the reference). The cache's tensors are written in
    place and shared by the returned cache. A model held as shards takes
    ``prefill``'s cache of rows, each row on its device, and returns the
    logits on the grid's first device in row order."""
    check_supported(cfg)
    model = as_sharded(params, cfg, ctx)
    with torch.inference_mode():
        idx = cache["idx"]
        if model is None:
            rows, ctxs, caches = [params], [ctx], [cache]
            tokens, encs = [token], [enc]
        else:
            rows, ctxs = _sharded_rows(model, cfg, ctx, len(token))
            caches = cache.get("rows")
            if caches is None or len(caches) != len(rows):
                raise ValueError(f"a model held as shards takes prefill's "
                                 f"cache of {len(rows)} rows")
            tokens = [torch.as_tensor(t).to(row.device) for t, row in
                      zip(_split_rows(token, len(rows)), rows)]
            encs = _split_rows(enc, len(rows))
        tensors = [t for t in ("k", "v", "state", "conv") if t in caches[0]]
        xs, positions = [], []
        for row, tok in zip(rows, tokens):
            x = embed_tokens(row, tok, cfg)
            if cfg.encoder_layers:
                x = x + decoder_pe(idx, cfg.d_model, x.device).to(cfg.dtype)
            xs.append(x)
            positions.append(torch.full(
                (len(tok), 1, 3) if cfg.mrope else (len(tok), 1), idx,
                dtype=torch.int32, device=x.device))
        encs = [e if e is None else e.to(device=x.device, dtype=cfg.dtype)
                for e, x in zip(encs, xs)]
        for li, window in enumerate(layer_windows(cfg)):
            lps = gathered_rows([row.layers[li] for row in rows])
            for r, lp in enumerate(lps):
                cache_l = {t: caches[r][t][li] for t in tensors}
                xs[r], new = _decode_layer(xs[r], lp, cfg,
                                           {**cache_l, "idx": idx},
                                           positions[r], window, encs[r],
                                           ctxs[r])
                for t, value in new.items():
                    cache_l[t].copy_(value)
            del lps
        logits = [logits_from_hidden(row, x, cfg) for row, x in zip(rows, xs)]
    out = [{**{t: c[t] for t in tensors}, "idx": idx + 1} for c in caches]
    if model is None:
        return logits[0], out[0]
    return _on_first(logits, model.device), {"idx": idx + 1, "rows": out}


def prefill(params, batch: Dict[str, Tensor], cfg: ModelConfig,
            max_len: int, ctx=None,
            enc: Optional[Tensor] = None) -> Tuple[Tensor, Cache]:
    """Prefill: run the whole prompt (batch: tokens (B, S) [+ positions
    (B, S) or (B, S, 3) for M-RoPE] [+ enc_input for the
    encoder-decoder]) after the meta tokens, build the cache, return the
    last position's logits (B, 1, V). Attention without a window whose
    mask is index-causal takes the flash kernel. ``enc``: the encoder
    states, if already computed (then ``enc_input`` is not read).

    A model held as shards (``ShardedLM``, or ``restore``'s {name:
    pieces} of ``ctx``'s grid): the batch is split over ``ctx``'s dp
    rows, each run on the row's first device; layer by layer, with the
    rows inner, each row gathers the layer onto its device (every row's
    copies queued before any row computes, models/sharded.py:
    ``gathered_rows``), runs it and drops it (a MoE layer's expert groups
    on the row's devices of each model index), so the cards run at
    once. The cache
    is {"idx", "rows": one cache a dp row, on the row's device}; the
    logits return on the grid's first device in row order."""
    check_supported(cfg)
    model = as_sharded(params, cfg, ctx)
    with torch.inference_mode():
        S = batch["tokens"].shape[1]
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        if model is None:
            rows, ctxs, parts, encs = [params], [ctx], [batch], [enc]
        else:
            rows, ctxs = _sharded_rows(model, cfg, ctx, len(batch["tokens"]))
            parts = _row_batches(batch, rows)
            encs = _split_rows(enc, len(rows))
        xs, poss, flash = [], [], True
        for row, part in zip(rows, parts):
            x, pos, f = _embed_prompt(row, part, cfg)
            xs.append(x)
            poss.append(pos)
            flash = flash and f
        if cfg.encoder_layers and encs[0] is None:
            if any(p.get("enc_input") is None for p in parts):
                raise ValueError(f"{cfg.name} (encoder-decoder) needs "
                                 f"batch['enc_input'] (B, T_enc, d_model)")
            encs = _encoder_rows(rows, [p["enc_input"] for p in parts], cfg,
                                 serving=True)
        elif cfg.encoder_layers:
            encs = [e.to(device=row.device, dtype=cfg.dtype)
                    for e, row in zip(encs, rows)]
        else:
            encs = [None] * len(rows)
        Sm = xs[0].shape[1]
        caches = [init_cache(cfg, x.shape[0], max_len, x.device) for x in xs]
        for li, window in enumerate(layer_windows(cfg)):
            lps = gathered_rows([row.layers[li] for row in rows])
            for r, lp in enumerate(lps):
                xs[r], kv, ssm_cache = _layer(xs[r], lp, cfg, poss[r],
                                              window, ctxs[r], flash,
                                              encs[r])
                cache = caches[r]
                if kv is not None:
                    cache["k"][li, :, :Sm] = kv[0]
                    cache["v"][li, :, :Sm] = kv[1]
                if ssm_cache is not None:
                    cache["state"][li] = ssm_cache["state"]
                    cache["conv"][li] = ssm_cache["conv"]
            del lps
        logits = [logits_from_hidden(row, x[:, -1:], cfg)
                  for row, x in zip(rows, xs)]
    for cache in caches:
        cache["idx"] = Sm
    if model is None:
        return logits[0], caches[0]
    return _on_first(logits, model.device), {"idx": Sm, "rows": caches}
