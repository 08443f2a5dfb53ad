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
``ShardedLM``, from ``init_params(..., shardings=)``), on one of two
paths that ``serve_path`` picks from the config and the grid alone
(``path_counts`` counts each call's):

  * "model" -- every family on a grid whose "model" axis is larger than
    1, in the reference's layout
    (repro/models/moe.py:88-102 ``act3`` / ``act_q`` /
    ``act_kv_gathered`` / ``act_logits``, repro/sharding/rules.py):
    prefill is context-parallel -- each dp row's sequence (hymba's meta
    tokens first) cut over the row's devices, each layer gathered whole
    onto every device of the row, K and V gathered in model-index order
    and each device's queries attending at their offset (the flash
    kernel's ``q_offset``; a window reads only its band); a MoE's
    all-to-all path takes each device's own tokens; the SSD of mamba2
    and hymba runs on the whole sequence's chunk grid, each device's
    local pass at once (reading the raw rows of its first chunk that lie
    on earlier devices), each device's entering state then handed on
    from the earlier devices' final states in model-index order
    (``_cp_ssm``). Whisper's encoder (``encode``, or ``prefill`` over
    ``enc_input``) is context-parallel the same way over each row's
    frames (the sinusoidal rows and RoPE positions at each chunk's own
    frames; every key visible: the flash kernel's non-causal chunk), its
    states ending whole on every device of the row (P(dp, None, None)),
    where each decoder chunk's cross-attention reads them. Decode is
    tensor-parallel on each device's own pieces (no layer gathered): the
    embedding a masked lookup in each device's vocab rows summed over
    "model" (whisper's decoder position row added on each device);
    q/k/v column pieces gathered (qk-norm and RoPE on whole heads: the
    columns may end inside a head); whisper's cross-attention from each
    device's ``xattn`` columns of the token's q and of the k / v of the
    states (by whole heads where the pieces hold them, else gathered);
    ``wo`` and ``w_down`` row pieces' partial sums added in f32 in
    model-index order and rounded once (gelu's ``w_up`` columns
    activated as pieces); the MoE's replicated path with expert group g
    on device g; ``lm_head``'s vocab columns gathered. The cache is
    pieces laid out by ``cache_specs_tree``
    fitted as the reference fits it (``init_cache(ctx=)``): by length
    over "model" (the softmax's max and sum reduced over the pieces),
    by heads under ``kv_heads``, whole on each model device where the
    axis does not divide; the SSM state by heads (each device stepping
    its own; all of them where the heads do not divide) and the conv rows
    whole on each model device, ``in_proj``'s column pieces gathered
    (they need not end at a head), the gated RMSNorm's sum of squares
    reduced over the devices in f32 in model-index order and
    ``out_proj``'s row pieces' partial sums reduced. The sharded train
    step
    (train/train_step.py:``jit_train_step``) takes the same path by the
    same rule (``train_path``): ``model_nll_sum`` is the context-parallel
    forward of one dp row -- the prefill's layer (``_cp_layer``) under
    the reentrant recompute, each layer gathered again in the backward
    (``sharded.gather_copies``: one copy a model index, whose backward
    sums the copies' gradients into each piece in f32 in model-index
    order), K and V, the SSD's conv rows and handed states gathered by
    ``sharded.seq_gather`` (its backward sums each chunk's partials in
    f32 in model-index order on the chunk's device, rounded once), the
    flash kernel's forward and backward at each chunk's ``q_offset`` --
    then each device's logits and next-token loss on its chunk with the
    labels cut the same way (the meta tokens' rows skipped), the head
    gathered whole onto each device; whisper's encoder first over
    its chunks of frames under the same recompute, its states gathered by
    ``seq_gather`` (every decoder chunk's gradient into them summed in
    f32 on each chunk's owner).
  * "rows" -- a model held as shards on a grid whose "model" axis is 1,
    where the reference's layout is FSDP: the batch runs over ``ctx``'s
    dp rows, each row on its
    first device, each layer gathered onto it as the layer runs (a MoE's
    expert groups on the row's devices of each model index); the cache
    is one whole cache a dp row.

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

import torch.nn.functional as F

from . import moe
from .attention import (_project_qkv, _sdpa, arange_positions, attend,
                        attend_chunk, attention, attention_decode,
                        cross_attention, decode_scores, decode_values,
                        index_causal, make_mask, qkv_heads, self_attend,
                        t_stream)
from .configs import ModelConfig
from .layers import mlp, norm, rmsnorm, sinusoidal_positions, swiglu
from .moe import ep_a2a_row, ep_replicated_row, moe_ffn
from .sharded import (ModelRow, ShardedLeaves, ShardedLM, all_gather,
                      all_reduce, as_sharded, fork, gathered_rows, namespace,
                      on_devices, reduce_scatter, reduce_to, row_model,
                      row_plans, seq_gather, shard_leaf)
from .ssm import (chunk_state, ssd_chunk, ssd_chunk_out, ssd_conv,
                  ssd_decode, ssd_decode_conv, ssd_decode_heads, ssd_forward,
                  ssd_project)

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
    pos = _prompt_positions(batch, cfg, B, S)
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


def _prompt_positions(batch: Dict[str, Tensor], cfg: ModelConfig, B: int,
                      S: int) -> Optional[Tensor]:
    """``batch["positions"]`` as a tensor where it stays (a host copy
    decides the flash route), checked against the prompt's (B, S); None
    for arange (ValueError for M-RoPE, which needs them)."""
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
    return pos


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
    shards (``ShardedLM``) runs its batch over ``ctx``'s dp rows on
    ``serve_path``'s path, as ``prefill`` does (over "model": each row's
    frames context-parallel over its devices); the states return on the
    grid's first device in row order."""
    check_supported(cfg)
    model = as_sharded(params, cfg, ctx)
    with torch.inference_mode():
        if model is None:
            return _encoder(params, enc_input, cfg)
        if serve_path(model, cfg, ctx) == "model":
            rows = _model_rows(model, _grid_ctx(model, ctx), len(enc_input))
            states = _model_encode(rows, _split_rows(enc_input, len(rows)),
                                   cfg)
            return _on_first([s[0] for s in states], model.device)
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
    return _nll(logits, torch.as_tensor(batch["labels"]))


def _nll(logits: Tensor, labels: Tensor) -> Tuple[Tensor, Tensor]:
    """f32 ``logits`` (B, S, V) against ``labels`` (B, S) -> (the sum of
    logsumexp - the gold logit over the valid positions, their count)."""
    labels = labels.to(logits.device)
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

def cache_shapes(cfg: ModelConfig, B: int, max_len: int
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{entry: (shape, dtype)} of ``init_cache``'s tensors."""
    L, out = cfg.n_layers, {}
    if cfg.has_attention:
        shape = (L, B, max_len + cfg.meta_tokens, cfg.n_kv_heads, cfg.hd)
        out["k"] = out["v"] = (shape, cfg.dtype)
    if cfg.has_ssm:
        out["state"] = ((L, B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                        torch.float32)
        out["conv"] = ((L, B, cfg.ssm_conv - 1, cfg.conv_dim), torch.float32)
    return out


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               device=None, ctx=None) -> Cache:
    """The cache, layer-stacked, zeros, on ``device`` (CUDA unless the CPU
    is asked for): "k", "v" (L, B, max_len + meta, K, hd) in the config's
    dtype where the family attends, "state" (L, B, H_ssm, N, P) and
    "conv" (L, B, k-1, conv_dim) in f32 where it has an SSM; "idx": 0.

    ``ctx``: the cache laid out on ``ctx``'s grid as the reference lays it
    out (sharding/rules.py: ``cache_shardings``, ``cache_specs_tree``
    fitted by ``fit_spec``: B over the dp axes; the length over "model",
    or the heads under the ``kv_heads`` profile; an axis a dimension does
    not divide by dropped) -> {"idx": 0, "pieces": {entry: one zero block
    a grid device, row-major, holders of a block on one device sharing
    one tensor}, "shardings": {entry: Sharding}}."""
    from ..core.detector import resolve_device
    check_supported(cfg)
    shapes = cache_shapes(cfg, B, max_len)
    if ctx is None:
        dev = resolve_device(device)
        cache: Cache = {"idx": 0}
        for name, (shape, dtype) in shapes.items():
            cache[name] = torch.zeros(shape, dtype=dtype, device=dev)
        return cache
    from ..sharding.rules import cache_shardings
    grid = ctx.grid
    shs = cache_shardings(cfg, grid, {k: s for k, (s, _) in shapes.items()},
                          ctx)
    pieces = {}
    for name, (shape, dtype) in shapes.items():
        sh, seen = shs[name], {}
        for b, dev in zip(sh.blocks(len(shape)), grid.flat):
            if (b, dev) not in seen:
                seen[(b, dev)] = torch.zeros(sh.block_shape(shape),
                                             dtype=dtype, device=dev)
        pieces[name] = [seen[(b, dev)] for b, dev in
                        zip(sh.blocks(len(shape)), grid.flat)]
    return {"idx": 0, "pieces": pieces, "shardings": shs}


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


# -------------------------------------- serving over the "model" axis

#: prefill and decode_step calls, and the sharded train step's gradients
#: (``train_path``), by path since the last reset_paths(): "whole" (a
#: CausalLM), "rows" (a model held as shards, a dp row a device) and
#: "model" (the reference's layout over "model")
path_counts: Dict[str, int] = {"whole": 0, "rows": 0, "model": 0}


def reset_paths() -> None:
    for k in path_counts:
        path_counts[k] = 0


def serve_path(params, cfg: ModelConfig, ctx=None) -> str:
    """The path ``prefill`` and ``decode_step`` take, from the model's
    kind and the grid alone: "whole" for a ``CausalLM``; "model" for a
    model held as shards on a grid whose "model" axis is larger than 1;
    "rows" for one on a grid whose "model" axis is 1, where the
    reference's layout is FSDP and the row path computes it."""
    model = as_sharded(params, cfg, ctx)
    if model is None:
        return "whole"
    return grid_path(cfg, _grid_ctx(model, ctx))


def grid_path(cfg: ModelConfig, ctx) -> str:
    """``serve_path``'s rule for a model held as shards on ``ctx``'s
    grid: "model" where its "model" axis is larger than 1, else "rows"
    (every family takes either)."""
    return "model" if ctx.grid.axis_sizes.get(ctx.tp_axis, 1) > 1 \
        else "rows"


def train_path(params, cfg: ModelConfig, ctx=None) -> str:
    """The path the sharded train step's gradient takes
    (train/train_step.py:``jit_train_step``), by ``serve_path``'s rule:
    "model" (``model_nll_sum``, context-parallel over the row's devices)
    for every family on a grid whose "model" axis is larger than 1,
    "rows" (a dp row a device) where it is 1; counted in
    ``path_counts``."""
    path = serve_path(params, cfg, ctx)
    path_counts[path] += 1
    return path


def _grid_ctx(model: ShardedLM, ctx):
    if ctx is None:
        from ..sharding.rules import make_ctx
        ctx = make_ctx(model.grid)
    return ctx


def _model_rows(model: ShardedLM, ctx, B: int) -> List[ModelRow]:
    rows = model.model_rows.get(ctx)
    if rows is None:
        rows = model.model_rows[ctx] = [ModelRow(model, p)
                                        for p in row_plans(ctx)]
    if B % len(rows):
        raise ValueError(f"a batch of {B} rows does not split over the "
                         f"grid's {len(rows)} dp rows")
    return rows


def _chunks(S: int, n: int) -> List[Tuple[int, int]]:
    """A sequence of S cut into n runs [s, e), ceil(S / n) long (the last
    ones shorter or empty where n does not divide S)."""
    c = -(-S // n)
    return [(min(g * c, S), min((g + 1) * c, S)) for g in range(n)]


def _embed_scale(cfg: ModelConfig) -> float:
    return float(torch.tensor(cfg.d_model ** 0.5).to(cfg.dtype))


def _tp_embed(row: ModelRow, toks: List[Tensor], cfg: ModelConfig,
              bounds: Optional[List[Tuple[int, int]]] = None
              ) -> List[Tensor]:
    """``embed_tokens`` over the row's devices: each looks the tokens up in
    its vocab rows (zero where another device holds the row), the
    lookups summed in model-index order -- one nonzero term, so exact --
    on every device, or, with ``bounds``, device g's run [s_g, e_g) of
    the sequence on device g (a reduce-scatter)."""
    ws, d = row.local("embed"), row.model_dim("embed")
    devs = row.devices
    if d is None:
        full = on_devices(devs, lambda g: ws[g][toks[g]])
        parts = full if bounds is None else [
            x[:, s:e] for x, (s, e) in zip(full, bounds)]
    else:
        Vl, parts = ws[0].shape[0], []
        for g, (w, t) in enumerate(zip(ws, toks)):
            i = t - g * Vl
            ok = (i >= 0) & (i < Vl)
            e = w[i.clamp(0, Vl - 1)]
            parts.append(torch.where(ok[..., None], e, e.new_zeros(())))
        parts = (all_reduce(parts, devs) if bounds is None
                 else reduce_scatter(parts, devs, bounds, 1))
    scale = _embed_scale(cfg)
    return on_devices(devs, lambda g: parts[g].to(cfg.dtype) * scale) \
        if bounds is None else [x.to(cfg.dtype) * scale for x in parts]


def _cols(row: ModelRow, name: str, xs: List[Tensor]
          ) -> Tuple[List[Tensor], bool]:
    """x @ w on each device: w split over "model" by columns gives each
    device its columns' product (split: True); w held whole, its whole
    product."""
    ws = row.local(name)
    if row.model_dim(name) is None:
        return on_devices(row.devices,
                          lambda g: torch.matmul(xs[g], ws[g])), False
    return [torch.matmul(x, w) for x, w in zip(xs, ws)], True


def _full(row: ModelRow, parts: List[Tensor], split: bool) -> List[Tensor]:
    """Column pieces gathered in model-index order onto every device."""
    return all_gather(parts, row.devices, -1) if split else parts


def _mm_f32(x: Tensor, w: Tensor) -> Tensor:
    """x @ w into f32: bf16 operands on a card multiply into f32 (the
    product the whole matmul rounds once), anything else in f32."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(
                            *x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def _rows(row: ModelRow, name: str, xs: List[Tensor], split: bool
          ) -> List[Tensor]:
    """x @ w on every device for w split over "model" by rows: each device
    the product of its rows with its columns of x (``split``: x is
    already in those pieces) in f32, the partial sums added in
    model-index order on every device (the reference's psum) and rounded
    once to x's dtype, as the whole product is; w held whole: the whole
    product."""
    ws = row.local(name)
    if row.model_dim(name) is None:
        xs = _full(row, xs, split)
        return on_devices(row.devices, lambda g: torch.matmul(xs[g], ws[g]))
    if not split:
        n = ws[0].shape[0]
        xs = [x[..., g * n:(g + 1) * n] for g, x in enumerate(xs)]
    dtype = xs[0].dtype
    sums = all_reduce([_mm_f32(x, w) for x, w in zip(xs, ws)], row.devices)
    return on_devices(row.devices, lambda g: sums[g].to(dtype))


def _tp_mlp(row: ModelRow, prefix: str, hs: List[Tensor],
            kind: str = "swiglu") -> List[Tensor]:
    """The MLP tensor-parallel: the up (and SwiGLU's gate) columns on each
    device (``w_gate`` and ``w_up`` split alike), the activation on the
    pieces (elementwise, so exactly the whole's; gelu's tanh form), the
    down rows' partial sums reduced in model-index order."""
    up, split = _cols(row, f"{prefix}.w_up", hs)
    if kind == "gelu":
        def act_of(g):
            return F.gelu(up[g], approximate="tanh")
    else:
        gate, _ = _cols(row, f"{prefix}.w_gate", hs)

        def act_of(g):
            return F.silu(gate[g]) * up[g]
    act = ([act_of(g) for g in range(row.tp)] if split
           else on_devices(row.devices, act_of))
    return _rows(row, prefix + ".w_down", act, split)


def _tp_moe(row: ModelRow, prefix: str, hs: List[Tensor],
            cfg: ModelConfig) -> List[Tensor]:
    """A decode step's MoE FFN: expert group g on device g (its pieces),
    every device routing the row's tokens (the replicated EP path), the
    groups' shares summed in model-index order on every device; the
    shared expert tensor-parallel, as the MLP."""
    names = ("router", "w_gate", "w_up", "w_down")
    loc = {n: row.local(f"{prefix}.{n}") for n in names}
    devs = row.devices
    if all(row.model_dim(f"{prefix}.{n}") == 0 for n in names[1:]):
        moe.path_counts["replicated"] += 1
        ys = all_reduce(ep_replicated_row(
            hs, [tuple(loc[n][g] for n in names) for g in range(row.tp)],
            devs, cfg), devs)
    else:
        moe.path_counts["local"] += 1
        ys = on_devices(devs, lambda g: moe._moe_local(
            hs[g], namespace({n: loc[n][g] for n in names}), cfg))
    if cfg.shared_expert:
        sh = _tp_mlp(row, prefix + ".shared", hs, cfg.mlp)
        ys = on_devices(devs, lambda g: ys[g] + sh[g])
    return ys


def _write_kv(piece: Tensor, box, li: int, kv: Tensor, s0: int) -> None:
    """kv (B, n, K, hd) at positions s0 .. s0 + n - 1 into layer li of a
    cache piece whose block is ``box`` (its slices of (L, B, S, K, hd)):
    the positions and heads the block holds."""
    ls, hs = box[2], box[3]
    a, b = max(ls.start, s0), min(ls.stop, s0 + kv.shape[1])
    if a < b:
        piece[li, :, a - ls.start:b - ls.start] = \
            kv[:, a - s0:b - s0, hs].to(piece.device, piece.dtype)


def _cache_view(cache: Cache, row: ModelRow, name: str):
    """Each device's cache piece of ``name`` and its block's slices, and
    the dimension split over "model" (2 the length, 3 the heads, None
    whole on each model device)."""
    sh, pieces = cache["shardings"][name], cache["pieces"][name]
    shape = tuple(n * c for n, c in zip(pieces[0].shape,
                                         sh.counts(pieces[0].dim())))
    boxes = sh.slices(shape)
    return ([pieces[f] for f in row.flat], [boxes[f] for f in row.flat],
            sh.model_dim(len(shape)))


def _qkv_cols(row: ModelRow, prefix: str, hs: List[Tensor]
              ) -> List[List[Tensor]]:
    """q, k and v whole on every device from their column pieces: one
    gather of each device's three pieces side by side where all three
    split over "model" (one exchange between the cards a layer, not
    three), else each on its own."""
    cols = [_cols(row, f"{prefix}.{w}", hs) for w in ("wq", "wk", "wv")]
    if not all(split for _, split in cols):
        return [_full(row, *c) for c in cols]
    n = [c[0][0].shape[-1] for c in cols]
    both = all_gather([torch.cat([c[0][g] for c in cols], -1)[None]
                       for g in range(row.tp)], row.devices, 0)
    # (tp, B, 1, nq + nk + nv) -> each (B, 1, tp * n) in model-index order
    per = on_devices(row.devices, lambda g: [
        t.movedim(0, -2).reshape(*t.shape[1:-1], -1)
        for t in both[g].split(n, -1)])
    return [[x[i] for x in per] for i in range(3)]


def _tp_attention_decode(row: ModelRow, prefix: str, hs: List[Tensor],
                         pos: List[Tensor], cache: Cache, li: int, idx: int,
                         window: int, cfg: ModelConfig) -> List[Tensor]:
    """A decode step's attention: q/k/v column pieces gathered (qk-norm
    and RoPE on whole heads), the new key and value written into the
    pieces that hold position idx, attention over each device's piece --
    by length: partial softmaxes merged in model-index order; by heads:
    each device its heads, gathered; whole: each device all of it --
    then the wo rows' partial sums reduced."""
    devs = row.devices
    p = row.local_tree(prefix)
    q, k, v = _qkv_cols(row, prefix, hs)
    qkv = on_devices(devs, lambda g: qkv_heads(q[g], k[g], v[g], p[g], cfg,
                                               pos[g]))
    (kp, boxes, dim), (vp, _, _) = (_cache_view(cache, row, n)
                                    for n in ("k", "v"))
    for g in range(row.tp):
        _write_kv(kp[g], boxes[g], li, qkv[g][1], idx)
        _write_kv(vp[g], boxes[g], li, qkv[g][2], idx)
    q_pos = [t_stream(x)[:, -1:] for x in pos]
    B = hs[0].shape[0]
    if dim == 2:
        # the whole cache's softmax over the gathered scores (a few bytes a
        # key), each device's P.V share of its piece, the shares summed
        # in f32 and rounded once
        s = all_gather([decode_scores(qkv[g][0], kp[g][li], q_pos[g],
                                      boxes[g][2].start, window=window,
                                      n_meta=cfg.meta_tokens)
                        for g in range(row.tp)], devs, -1)
        w = on_devices(devs, lambda g: torch.softmax(s[g], -1))
        out = all_reduce([decode_values(w[g][..., b[2]], vp[g][li])
                          for g, b in enumerate(boxes)], devs)
        out = on_devices(devs, lambda g: out[g].to(cfg.dtype))
    else:
        def attend(g, heads):
            rep = cfg.n_heads // cfg.n_kv_heads
            qh = qkv[g][0][:, :, heads.start * rep:heads.stop * rep]
            S = kp[g].shape[2]
            mask = make_mask(q_pos[g], torch.arange(S, device=devs[g])[None],
                             window=window, n_meta=cfg.meta_tokens)
            return _sdpa(qh, kp[g][li], vp[g][li], mask, cfg)
        if dim == 3:
            out = all_gather([attend(g, boxes[g][3]) for g in range(row.tp)],
                             devs, 2)
        else:
            out = on_devices(devs, lambda g: attend(g, boxes[g][3]))
    flat = [o.reshape(B, 1, cfg.n_heads * cfg.hd) for o in out]
    return _rows(row, prefix + ".wo", flat, False)


def _tp_ssm_decode(row: ModelRow, prefix: str, hs: List[Tensor],
                   cache: Cache, li: int, cfg: ModelConfig) -> List[Tensor]:
    """A decode step's SSD, tensor-parallel: ``in_proj``'s column pieces
    gathered (``_full``: they need not end at a head); the conv from the
    whole ``conv_w`` / ``conv_b`` and the cache's ``conv``, whole on each
    device; each device steps the heads its ``state`` piece holds (all
    of them where the fit keeps the state whole) and writes them back;
    the gated RMSNorm on each device's ``norm_scale`` rows, their sum of
    squares over d_inner added in f32 in model-index order; the
    ``out_proj`` rows' partial sums reduced (``_rows``). Every value is
    computed before a piece is written: holders of a block on one device
    share its tensor."""
    devs, tp = row.devices, row.tp
    di, C = cfg.d_inner, cfg.conv_dim
    dtype = hs[0].dtype
    p = row.local_tree(prefix)
    zx, split = _cols(row, prefix + ".in_proj", hs)
    zx = _full(row, zx, split)
    (sp, boxes, heads_split), (cp, _, _) = (_cache_view(cache, row, n)
                                            for n in ("state", "conv"))
    conv = on_devices(devs, lambda g: ssd_decode_conv(
        cp[g][li], zx[g][:, 0, di:di + C], p[g], dtype))
    memo: Dict[int, Tuple[Tensor, Tensor]] = {}
    for g in range(tp):
        if id(sp[g]) not in memo:
            memo[id(sp[g])] = ssd_decode_heads(
                conv[g][0], zx[g][:, 0, di + C:], zx[g][:, 0, :di],
                sp[g][li], boxes[g][2], p[g], cfg)
    new = [memo[id(sp[g])] for g in range(tp)]
    for g in range(tp):
        sp[g][li] = new[g][0]
        cp[g][li] = conv[g][1]
    P = cfg.ssm_headdim
    if row.model_dim(prefix + ".norm_scale") is None:
        # the norm's rows whole: every device the whole gated output
        us = _full(row, [u for _, u in new], heads_split is not None)
        ys = on_devices(devs, lambda g: rmsnorm(us[g], p[g].norm_scale,
                                                cfg.norm_eps))
        return _rows(row, prefix + ".out_proj", ys, False)
    n = di // tp
    cols = [new[g][1][..., g * n - boxes[g][2].start * P:
                      (g + 1) * n - boxes[g][2].start * P]
            for g in range(tp)]
    ss = all_reduce([c.to(torch.float32).square().sum(-1, keepdim=True)
                     for c in cols], devs)
    ys = [(c.to(torch.float32) * torch.rsqrt(s / di + cfg.norm_eps)
           * w.norm_scale.to(torch.float32)).to(dtype)
          for c, s, w in zip(cols, ss, p)]
    return _rows(row, prefix + ".out_proj", ys, True)


def _tp_branch_norm(row: ModelRow, name: str, xs: List[Tensor],
                    cfg: ModelConfig) -> List[Tensor]:
    """hymba's norm of one branch of its mixer (``bn_attn``, ``bn_ssm``)
    on each device; any other family's branch as it is."""
    if cfg.family != "hybrid":
        return xs
    bn = row.local_tree(name)
    return on_devices(row.devices, lambda g: norm(xs[g], bn[g], cfg.norm,
                                                  cfg.norm_eps))


def _tp_cross_attention(row: ModelRow, prefix: str, hs: List[Tensor],
                        encs: List[Tensor], cfg: ModelConfig
                        ) -> List[Tensor]:
    """A decode step's cross-attention, tensor-parallel: each device its
    ``wq`` columns of the token's q and its ``wk`` / ``wv`` columns of the
    k and v of the whole encoder states it holds (``encs``). Where every
    piece holds whole heads, each device attends with its own heads and
    the ``wo`` rows' partial sums are reduced; where the columns end
    inside a head (or a projection is held whole), q, k and v are
    gathered whole onto every device first, as ``_qkv_cols`` does."""
    B, hd = hs[0].shape[0], cfg.hd
    (q, sq), (k, sk), (v, sv) = (_cols(row, f"{prefix}.{w}", xs) for w, xs
                                 in (("wq", hs), ("wk", encs),
                                     ("wv", encs)))
    own = sq and sk and sv and q[0].shape[-1] % hd == 0 \
        and k[0].shape[-1] % hd == 0
    if not own:
        q, k, v = (_full(row, t, split) for t, split in
                   ((q, sq), (k, sk), (v, sv)))

    def attend_heads(g):
        T = k[g].shape[1]
        out = _sdpa(q[g].view(B, 1, -1, hd), k[g].view(B, T, -1, hd),
                    v[g].view(B, T, -1, hd), None, cfg)
        return out.reshape(B, 1, -1)
    outs = ([attend_heads(g) for g in range(row.tp)] if own
            else on_devices(row.devices, attend_heads))
    return _rows(row, prefix + ".wo", outs, own)


def _placed_states(rows: List[ModelRow], enc: Tensor, cfg: ModelConfig
                   ) -> List[List[Tensor]]:
    """Encoder states (B, T, D) as the decoder over "model" reads them
    (the reference's P(dp, None, None)): each dp row's, whole, on every
    device of the row, in the model's dtype."""
    return [on_devices(row.devices, lambda g, row=row, e=e: e.to(
        row.devices[g], cfg.dtype)) for row, e in
        zip(rows, _split_rows(enc, len(rows)))]


def _tp_logits(row: ModelRow, xs: List[Tensor], cfg: ModelConfig
               ) -> Tensor:
    """``logits_from_hidden`` over the row's devices: the final norm on
    each, each device's vocab columns of the head (``lm_head``, or the
    tied ``embed``'s rows), gathered in order on the row's first device."""
    fn = row.local_tree("final_norm")
    devs = row.devices
    h = on_devices(devs, lambda g: norm(xs[g], fn[g], cfg.norm,
                                        cfg.norm_eps))
    name = "embed" if cfg.tie_embeddings else "lm_head"
    ws, d = row.local(name), row.model_dim(name)
    heads = [w.T if cfg.tie_embeddings else w for w in ws]
    if d is None:
        return torch.matmul(h[0], heads[0].to(cfg.dtype))
    return torch.cat([torch.matmul(x, w.to(cfg.dtype)).to(devs[0])
                      for x, w in zip(h, heads)], -1)


def _model_decode(model: ShardedLM, token, cache: Cache, cfg: ModelConfig,
                  ctx, enc: Optional[Tensor] = None) -> Tuple[Tensor, Cache]:
    """``decode_step`` in the reference's layout: each dp row's tokens on
    every device of the row, every product on the pieces each device
    holds (no layer gathered), the cache written and read in its pieces;
    whisper's decoder position row added to each device's embedding and
    its cross-attention over ``enc``, whole on every device of the row
    (the copies prefill placed, where ``enc`` is the tensor it was
    given)."""
    if "pieces" not in cache or next(iter(cache["shardings"].values())
                                     ).grid != model.grid:
        raise ValueError("a model held as shards over the 'model' axis "
                         "takes prefill's cache of pieces on its grid, not "
                         "one of whole tensors or of dp rows")
    rows = _model_rows(model, ctx, len(token))
    idx = cache["idx"]
    placed = cache.get("enc")
    if enc is None or not cfg.encoder_layers:
        encs = [None] * len(rows)
    elif placed is not None and placed[0] is enc:
        encs = placed[1]
    else:
        encs = _placed_states(rows, enc, cfg)
    states = []
    for row, tok in zip(rows, _split_rows(token, len(rows))):
        devs = row.devices
        toks = on_devices(devs, lambda g: torch.as_tensor(tok).to(devs[g]))
        shape = (len(tok), 1, 3) if cfg.mrope else (len(tok), 1)
        pos = on_devices(devs, lambda g: torch.full(
            shape, idx, dtype=torch.int32, device=devs[g]))
        xs = _tp_embed(row, toks, cfg)
        if cfg.encoder_layers:
            xs = on_devices(devs, lambda g: xs[g] + decoder_pe(
                idx, cfg.d_model, devs[g]).to(cfg.dtype))
        states.append([xs, pos])
    for li, window in enumerate(layer_windows(cfg)):
        lp = f"layers.{li}."
        for row, st, e in zip(rows, states, encs):
            xs, pos = st
            devs = row.devices
            ln1, ln2 = (row.local_tree(lp + n) for n in ("ln1", "ln2"))
            h = on_devices(devs, lambda g: norm(
                xs[g], ln1[g], cfg.norm, cfg.norm_eps))
            outs = []
            if cfg.has_attention:
                outs.append(_tp_branch_norm(row, lp + "bn_attn",
                                            _tp_attention_decode(
                                                row, lp + "attn", h, pos,
                                                cache, li, idx, window, cfg),
                                            cfg))
            if cfg.has_ssm:
                outs.append(_tp_branch_norm(row, lp + "bn_ssm",
                                            _tp_ssm_decode(
                                                row, lp + "ssm", h, cache,
                                                li, cfg), cfg))
            xs = on_devices(devs, lambda g: xs[g] + _mix([o[g]
                                                          for o in outs]))
            if e is not None:
                lnx = row.local_tree(lp + "ln_x")
                h = on_devices(devs, lambda g: norm(
                    xs[g], lnx[g], cfg.norm, cfg.norm_eps))
                c = _tp_cross_attention(row, lp + "xattn", h, e, cfg)
                xs = on_devices(devs, lambda g: xs[g] + c[g])
            if cfg.family == "ssm":
                st[0] = xs
                continue
            h = on_devices(devs, lambda g: norm(
                xs[g], ln2[g], cfg.norm, cfg.norm_eps))
            f = (_tp_moe(row, lp + "moe", h, cfg) if cfg.is_moe
                 else _tp_mlp(row, lp + "mlp", h, cfg.mlp))
            st[0] = on_devices(devs, lambda g: xs[g] + f[g])
    logits = [_tp_logits(row, st[0], cfg) for row, st in zip(rows, states)]
    return _on_first(logits, model.device), {**cache, "idx": idx + 1}


def _cp_moe(row: ModelRow, lps, hs: List[Tensor], cfg: ModelConfig, ctx,
            bounds: List[Tuple[int, int]]) -> List[Tensor]:
    """A context-parallel pass's MoE FFN on each device's own tokens
    (prefill, and the train step under autograd): the all-to-all
    path where the sequence splits evenly (expert group g on device g),
    else the replicated path over the row's gathered tokens, each device
    then keeping its run; the shared expert on each device's tokens."""
    devs, tp = row.devices, row.tp
    S = bounds[-1][1]
    groups = getattr(lps[0].moe, "ep_groups", None)
    if groups is not None:
        gl = [groups[(g, devs[g])] for g in range(tp)]
        if ctx.seq_sharded and S % tp == 0:
            path, ys = "a2a", ep_a2a_row(hs, gl, devs, cfg)
        else:
            full = all_gather(hs, devs, 1)
            path, ys = "replicated", reduce_scatter(
                ep_replicated_row(full, gl, devs, cfg), devs, bounds, 1)
    else:
        full = all_gather(hs, devs, 1)
        outs = on_devices(devs, lambda g: moe._moe_local(full[g], lps[g].moe,
                                                         cfg))
        path, ys = "local", [o[:, s:e] for o, (s, e) in zip(outs, bounds)]
    moe.path_counts[path] += 1
    if cfg.shared_expert:
        ys = [y + swiglu(h, lp.moe.shared) for y, h, lp in zip(ys, hs, lps)]
    return ys


def _cp_positions(batch: Dict[str, object], cfg: ModelConfig, B: int,
                  S: int) -> Tuple[Tensor, bool]:
    """A context-parallel pass's positions on the host: ``batch``'s (B, S)
    or (B, S, 3), or arange, after the meta tokens' arange where the
    config has them (the tokens' shifted by M, as ``_embed_prompt``
    shifts them) -> (positions (B, M + S[, 3]), whether their mask is
    index-causal)."""
    pos = _prompt_positions(batch, cfg, B, S)
    M = cfg.meta_tokens
    if M and pos is not None:
        if pos.dim() != 2:
            raise ValueError("meta tokens take (B, S) positions")
        pos = torch.cat([torch.arange(M).expand(B, M), pos + M], 1)
    flash = index_causal(pos)
    if pos is None:
        pos = arange_positions(B, M + S, "cpu")
    return pos, flash


def _cp_inputs(row: ModelRow, tok: Tensor, pos: Tensor,
               bounds: List[Tuple[int, int]], cfg: ModelConfig) -> dict:
    """A context-parallel pass's inputs on a dp row: device g's chunk
    [s_g, e_g) of the sequence -- hymba's meta tokens first, then the
    embedded tokens (``_tp_embed``; whisper's sinusoidal rows s_g .. e_g
    - 1 added) -- and of the positions (``_cp_positions``: (B, M + S) or
    (B, S, 3)) ("q_pos"), and the whole sequence's t stream on every
    device ("k_pos")."""
    devs = row.devices
    M = cfg.meta_tokens
    toks = on_devices(devs, lambda g: tok.to(devs[g]))
    xs = _tp_embed(row, toks, cfg, [(max(s - M, 0), max(e - M, 0))
                                     for s, e in bounds])
    if M:
        meta = row.local("meta")
        xs = [torch.cat([m[s:min(e, M)].to(cfg.dtype).expand(
            x.shape[0], -1, -1), x], 1)
            for x, m, (s, e) in zip(xs, meta, bounds)]
    if cfg.encoder_layers and not cfg.mrope:
        xs = [x + sinusoidal_positions(e - s, cfg.d_model, d, start=s).to(
            cfg.dtype)[None] for x, d, (s, e) in zip(xs, devs, bounds)]
    return {"x": xs,
            "q_pos": [pos[:, s:e].to(d) for d, (s, e) in zip(devs, bounds)],
            "k_pos": on_devices(devs, lambda g: t_stream(pos).to(devs[g]))}


def _cp_attention(row: ModelRow, lp, hs: List[Tensor], q_pos: List[Tensor],
                  cfg: ModelConfig, attend_fn):
    """The self-attention of a context-parallel layer on its normed chunks
    ``hs``, ``lp`` the layer whole on each device: each chunk's q, k and
    v (RoPE at its positions ``q_pos``); K and V side by side gathered in
    model-index order (``seq_gather``: one exchange between the cards,
    and under grad its f32 backward); ``attend_fn(g, q, k, v)`` each
    chunk's queries against the whole sequence's keys. -> (each chunk's
    output after ``wo``, each device's whole k, whole v)."""
    H, hd = cfg.n_heads, cfg.hd

    def project(h, p, qp):
        # q's gradient is the device's own, k's and v's wait on the
        # gather's backward: one alias a projection (``fork``)
        hq, hk, hv = fork(h, h, h)
        return qkv_heads(torch.matmul(hq, p.wq), torch.matmul(hk, p.wk),
                         torch.matmul(hv, p.wv), p, cfg, qp)
    qkv = [project(h, p.attn, qp) for h, p, qp in zip(hs, lp, q_pos)]
    kv = seq_gather([torch.cat(t[1:], -1) for t in qkv], row.devices)
    k = [x[..., :hd] for x in kv]
    v = [x[..., hd:] for x in kv]
    outs = [torch.matmul(attend_fn(g, t[0], k[g], v[g]).reshape(
        h.shape[0], h.shape[1], H * hd), lp[g].attn.wo)
        for g, (h, t) in enumerate(zip(hs, qkv))]
    return outs, k, v


def _last_rows(x: Tensor, n: int) -> Tensor:
    """The last n rows of x (B, S, C) along S, zeros before where S < n."""
    return F.pad(x[:, max(x.shape[1] - n, 0):], (0, 0, max(n - x.shape[1],
                                                           0), 0))


def _handing_on(c: Dict[str, object], owned: int) -> Dict[str, object]:
    """A device's local pass (``ssd_chunk``) with the state and decay of
    its first ``owned`` chunks (``chunk_state``) that it hands on. The
    hand-off's uses wait on other devices, the run's own output's do not:
    under grad the pass is differentiated once both are in (``fork``)."""
    *ys, states, decay, cum, C, xh, states_h, decay_h = fork(
        *c["y_intra"], c["states"], c["chunk_decay"], c["cum"], c["C"],
        c["xh"], c["states"], c["chunk_decay"])
    state, total = chunk_state(states_h, decay_h, owned)
    return dict(c, y_intra=ys, states=states, chunk_decay=decay,
                cum=cum, C=C, xh=xh, state=state, decay=total)


def _cp_ssm(row: ModelRow, lp, hs: List[Tensor], cfg: ModelConfig,
            cache: bool = False):
    """The SSD of a context-parallel layer on its normed runs ``hs``,
    ``lp`` the layer whole on each device, on the whole sequence's chunk
    grid (Q = min(ssm_chunk, S)), so each product is the whole path's:
    each run's ``in_proj``; each run's last raw xBC and dt_raw rows (as
    many as a later run's first chunk and conv can reach back, Q + k -
    2) gathered in model-index order (``seq_gather``), so each device
    reads its first chunk's rows on earlier devices and the k-1 before;
    each device's local pass (``ssd_chunk``), all at once; the final
    states and total decays of the chunks that end on each device
    gathered the same way, and each device's entering state E_g =
    E_{g-1} D_{g-1} + F_{g-1} from them in model-index order; each run's
    output from its entering state (``ssd_chunk_out``). Under grad, each
    exchange's backward sums its gradients in f32 in model-index order.
    -> (each run's output, and with ``cache`` each device's final cache
    {"state" (B, H, N, P) after the whole sequence, "conv" its last k-1
    raw rows, f32}, else None)."""
    devs, k1, H = row.devices, cfg.ssm_conv - 1, cfg.ssm_heads
    bounds, s = [], 0
    for h in hs:
        bounds.append((s, s + h.shape[1]))
        s += h.shape[1]
    Q = min(cfg.ssm_chunk, s)
    proj = [ssd_project(h, p.ssm, cfg) for h, p in zip(hs, lp)]
    n = Q - 1 + k1
    tails = seq_gather([r[:, max(r.shape[1] - n, 0):] for _, r in proj],
                       devs)
    ends = [0]
    for a, b in bounds:
        ends.append(ends[-1] + min(b - a, n))
    local = []
    for g, ((a, b), (z, r), p) in enumerate(zip(bounds, proj, lp)):
        if a == b:
            # an empty run: a zero state and no decay to hand on
            shape = (z.shape[0], H, cfg.ssm_state, cfg.ssm_headdim)
            local.append({"state": z.new_zeros(shape, dtype=torch.float32),
                          "decay": z.new_ones(shape[:2],
                                              dtype=torch.float32)})
            continue
        lead = a - a // Q * Q
        owned = sum(min(a - lead + (i + 1) * Q, s) <= b
                    for i in range(-(-(b - a + lead) // Q)))
        xBC, dt = ssd_conv(torch.cat([_last_rows(tails[g][:, :ends[g]],
                                                 lead + k1), r], 1), p.ssm,
                           cfg)
        local.append(_handing_on(ssd_chunk(z, xBC, dt, lead, Q, p.ssm, cfg),
                                 owned))
    handed = seq_gather([torch.cat([c["state"].flatten(1), c["decay"]],
                                   -1)[:, None] for c in local], devs)

    def entering(g: int, upto: int) -> Optional[Tensor]:
        E = None
        for j in range(upto):
            F_j = handed[g][:, j, :-H].view(local[j]["state"].shape)
            E = F_j if E is None else E * handed[g][:, j, -H:, None,
                                                    None] + F_j
        return E
    outs = [h.new_zeros(h.shape) if a == b
            else ssd_chunk_out(c, entering(g, g), p.ssm, cfg)[0]
            for g, (h, (a, b), c, p) in enumerate(zip(hs, bounds, local, lp))]
    if not cache:
        return outs, None
    return outs, on_devices(devs, lambda g: {
        "state": entering(g, row.tp),
        "conv": _last_rows(tails[g], k1)[..., :cfg.conv_dim].to(
            torch.float32)})


def _cp_layer(row: ModelRow, lp, xs: List[Tensor], q_pos: List[Tensor],
              k_pos: List[Tensor], bounds: List[Tuple[int, int]],
              window: int, cfg: ModelConfig, ctx, flash: bool,
              enc: Optional[List[Tensor]] = None, cache: bool = False):
    """One decoder layer of a context-parallel pass over a dp row, ``lp``
    the layer whole on each device: its mixer on each chunk's normed
    input -- the self-attention (``_cp_attention``) with each chunk's
    queries attending at its offset (``attend_chunk``), the SSD
    (``_cp_ssm``), or hymba's two side by side, each after its branch
    norm, averaged; whisper's cross-attention of each chunk's queries
    over the encoder states its device holds (``enc``); the FFN on each
    device's own tokens (mamba2 has none). -> (xs, (each device's whole
    k, whole v) or None, with ``cache`` each device's SSM cache or
    None)."""
    hs = [norm(x, p.ln1, cfg.norm, cfg.norm_eps) for x, p in zip(xs, lp)]
    outs, kv, ssm = [], None, None
    if cfg.has_attention:
        a, k, v = _cp_attention(row, lp, hs, q_pos, cfg, lambda g, q, kg, vg:
                                attend_chunk(q, kg, vg, cfg,
                                             t_stream(q_pos[g]), k_pos[g],
                                             bounds[g][0], window=window,
                                             n_meta=cfg.meta_tokens, ctx=ctx,
                                             flash=flash))
        if cfg.family == "hybrid":
            a = [norm(t, p.bn_attn, cfg.norm, cfg.norm_eps)
                 for t, p in zip(a, lp)]
        outs.append(a)
        kv = (k, v)
    if cfg.has_ssm:
        o, ssm = _cp_ssm(row, lp, hs, cfg, cache)
        if cfg.family == "hybrid":
            o = [norm(t, p.bn_ssm, cfg.norm, cfg.norm_eps)
                 for t, p in zip(o, lp)]
        outs.append(o)
    xs = [x + _mix([o[g] for o in outs]) for g, x in enumerate(xs)]
    if enc is not None:
        xs = [x + cross_attention(norm(x, p.ln_x, cfg.norm, cfg.norm_eps),
                                  e, p.xattn, cfg)
              for x, p, e in zip(xs, lp, enc)]
    if cfg.family == "ssm":
        return xs, kv, ssm
    hs = [norm(x, p.ln2, cfg.norm, cfg.norm_eps) for x, p in zip(xs, lp)]
    f = (_cp_moe(row, lp, hs, cfg, ctx, bounds) if cfg.is_moe
         else [mlp(h, p.mlp, cfg.mlp) for h, p in zip(hs, lp)])
    return [x + y for x, y in zip(xs, f)], kv, ssm


def _cp_train_layer(xs: List[Tensor], row: ModelRow, li: int, *args,
                    enc=None) -> List[Tensor]:
    """``_cp_layer`` of layer ``li``, gathered whole onto the row's
    devices here (and again in the recompute of the backward)."""
    return _cp_layer(row, row.whole_layer(li), xs, *args, enc=enc)[0]


def _cp_frames(row: ModelRow, frames, cfg: ModelConfig
               ) -> Tuple[List[Tensor], List[Tensor]]:
    """Whisper's encoder input on a dp row, cut over its devices (the
    reference's P(dp, "model", None)): device g's frames [s_g, e_g) of
    (B, T, D) (numpy or a tensor) in the model's dtype plus the
    sinusoidal rows s_g .. e_g - 1, and their arange positions (B,
    e_g - s_g) for the encoder's RoPE."""
    x = torch.as_tensor(frames)
    B, T, D = x.shape
    xs, pos = [], []
    for dev, (s, e) in zip(row.devices, _chunks(T, row.tp)):
        c = x[:, s:e].to(device=dev, dtype=cfg.dtype)
        xs.append(c + sinusoidal_positions(e - s, D, dev, start=s).to(
            cfg.dtype))
        pos.append(torch.arange(s, e, device=dev).expand(B, e - s))
    return xs, pos


def _cp_enc_layer(row: ModelRow, lp, xs: List[Tensor], pos: List[Tensor],
                  cfg: ModelConfig) -> List[Tensor]:
    """One encoder layer of a context-parallel pass over a dp row (the
    reference's ``act_q`` / ``act_kv_gathered``): each chunk's queries
    against the whole sequence's gathered K and V, every key visible (the
    flash kernel, ``causal=False``, Sq < Sk), then the MLP on each
    device's own frames."""
    a, _, _ = _cp_attention(row, lp, [norm(x, p.ln1, cfg.norm, cfg.norm_eps)
                                      for x, p in zip(xs, lp)],
                            pos, cfg, lambda g, q, k, v:
                            attend(q, k, v, causal=False))
    xs = [x + y for x, y in zip(xs, a)]
    return [x + mlp(norm(x, p.ln2, cfg.norm, cfg.norm_eps), p.mlp, cfg.mlp)
            for x, p in zip(xs, lp)]


def _cp_train_enc_layer(xs: List[Tensor], row: ModelRow, li: int,
                        pos: List[Tensor], cfg: ModelConfig) -> List[Tensor]:
    """``_cp_enc_layer`` of encoder layer ``li``, gathered whole onto the
    row's devices here (and again in the recompute of the backward)."""
    return _cp_enc_layer(row, row.whole_layer(li, "enc_layers"), xs, pos,
                         cfg)


def _cp_enc_states(row: ModelRow, xs: List[Tensor], cfg: ModelConfig
                   ) -> List[Tensor]:
    """The encoder's last chunks through ``enc_norm``, gathered whole onto
    every device of the row in model-index order (the decoder's P(dp,
    None, None)) by ``seq_gather``: under grad, each chunk's gradient --
    every decoder chunk's cross-attention sends it one -- summed in f32
    in model-index order on the chunk's device."""
    fn = row.local_tree("enc_norm")
    return seq_gather([norm(x, p, cfg.norm, cfg.norm_eps)
                       for x, p in zip(xs, fn)], row.devices)


def _model_encode(rows: List[ModelRow], inputs, cfg: ModelConfig
                  ) -> List[List[Tensor]]:
    """Whisper's encoder over "model" for serving: each dp row's frames
    cut over the row's devices (``_cp_frames``), each encoder layer
    gathered whole onto every device of every row (every row's copies
    queued before any computes) and run context-parallel
    (``_cp_enc_layer``) -> each row's states, whole on each of its
    devices (``_cp_enc_states``)."""
    sts = [_cp_frames(row, f, cfg) for row, f in zip(rows, inputs)]
    for li in range(cfg.encoder_layers):
        lps = [row.whole_layer(li, "enc_layers") for row in rows]
        sts = [(_cp_enc_layer(row, lp, xs, pos, cfg), pos)
               for row, lp, (xs, pos) in zip(rows, lps, sts)]
        del lps
    return [_cp_enc_states(row, xs, cfg) for row, (xs, _) in zip(rows, sts)]


def _cp_remat(fn, xs: List[Tensor], *args,
              enc: Optional[List[Tensor]] = None) -> List[Tensor]:
    """``fn(xs, *args)`` over a row's chunks (``fn(xs, *args, enc=enc)``
    where ``enc`` is given), recomputed in the
    backward where grad is enabled: only the chunks are kept, in the
    reentrant form, which recomputes the layer once before its backward
    fans out over the row's cards (as ``_remat`` for a layer held as
    shards). The encoder states ``enc`` are inputs of the recompute too,
    so their gradient returns through it (a tensor the block only closed
    over would be differentiated from inside each block's backward, down
    through the encoder each time). Where no input needs a gradient
    (the encoder over its frames) the chunks are made to carry one: the
    reentrant form differentiates only through its inputs, and the
    parameters gathered inside would get none (as in ``_remat``)."""
    def run(xs, enc):
        return fn(xs, *args) if enc is None else fn(xs, *args, enc=enc)
    if not torch.is_grad_enabled():
        return run(xs, enc)
    n = len(xs)
    ins = list(xs) + list(enc or ())
    if not any(t.requires_grad for t in ins):
        ins[:n] = [x.detach().requires_grad_() for x in xs]
    return list(checkpoint(lambda *t: tuple(run(list(t[:n]),
                                                list(t[n:]) or None)),
                           *ins, use_reentrant=True))


def model_nll_sum(row: ModelRow, batch: Dict[str, object],
                  cfg: ModelConfig, ctx) -> Tensor:
    """One dp row's next-token loss numerator in the reference's training
    layout (its batch at P(dp, "model"), repro/sharding/rules.py:193):
    the row's sequence (hymba's meta tokens first) cut over its devices,
    each layer gathered whole onto every device of the row and
    recomputed in the backward (``_cp_layer``), K and V gathered in
    model-index order and each chunk's queries attending at its offset
    (the flash kernel's forward and backward at ``q_offset``, or
    ``_sdpa`` under the chunk's rows of the mask: an image prompt, a
    window's band), the SSD's state handed on across the chunks, the
    MoE's all-to-all on each device's own tokens; then each device's
    logits (the final norm and the head, gathered whole) and its
    ``_nll`` on its chunk of the labels (the meta tokens' rows
    skipped). Whisper's encoder runs first
    over the row's frames, context-parallel (each encoder layer under the
    same recompute, every key visible: the flash kernel's non-causal
    forward and backward on each chunk of frames); its states, gathered
    whole onto every device (``_cp_enc_states``), feed each decoder
    chunk's cross-attention. ``batch``: the row's tokens and labels (B,
    S) [+ positions (B, S) or (B, S, 3)] [+ enc_input (B, T, D)] on the
    host. -> the chunks' numerators in f32, added in model-index order
    on the row's first device."""
    tokens = torch.as_tensor(batch["tokens"])
    B, S = tokens.shape
    pos, flash = _cp_positions(batch, cfg, B, S)
    M = cfg.meta_tokens
    enc = None
    if cfg.encoder_layers:
        xs, epos = _cp_frames(row, _need_frames(batch, cfg), cfg)
        for li in range(cfg.encoder_layers):
            xs = _cp_remat(_cp_train_enc_layer, xs, row, li, epos, cfg)
        enc = _cp_enc_states(row, xs, cfg)
    bounds = _chunks(M + S, row.tp)
    st = _cp_inputs(row, tokens, pos, bounds, cfg)
    xs = st["x"]
    for li, window in enumerate(layer_windows(cfg)):
        xs = _cp_remat(_cp_train_layer, xs, row, li, st["q_pos"],
                       st["k_pos"], bounds, window, cfg, ctx, flash,
                       enc=enc)
    devs = row.devices
    fn = row.local_tree("final_norm")
    head = row.whole("embed" if cfg.tie_embeddings else "lm_head")
    labels = torch.as_tensor(batch["labels"])
    parts = []
    for g, (x, (s, e)) in enumerate(zip(xs, bounds)):
        w = head[g].T if cfg.tie_embeddings else head[g]
        skip = min(max(M - s, 0), e - s)          # the meta tokens' rows
        logits = torch.matmul(norm(x[:, skip:], fn[g], cfg.norm,
                                   cfg.norm_eps),
                              w.to(cfg.dtype)).to(torch.float32)
        parts.append(_nll(logits, labels[:, s + skip - M:e - M])[0])
    return reduce_to(parts, devs[0])


def _need_frames(batch: Dict[str, object], cfg: ModelConfig):
    if batch.get("enc_input") is None:
        raise ValueError(f"{cfg.name} (encoder-decoder) needs "
                         f"batch['enc_input'] (B, T_enc, d_model)")
    return batch["enc_input"]


def _model_prefill(model: ShardedLM, batch: Dict[str, Tensor],
                   cfg: ModelConfig, max_len: int, ctx,
                   enc: Optional[Tensor] = None) -> Tuple[Tensor, Cache]:
    """``prefill`` in the reference's layout: each dp row's sequence
    (hymba's meta tokens first) cut over the row's devices (context
    parallelism), each layer gathered whole onto every device of the row
    (every row's copies queued before any computes) and run by
    ``_cp_layer``; the cache built as pieces (``init_cache(ctx=)``),
    each device writing its piece from the gathered K and V, and its
    heads of the SSM's final state and the whole conv rows; the last
    position's logits over the vocab columns. Whisper: the encoder over
    "model" first (``_model_encode``) unless ``enc`` is given, whose
    copies, placed once on every device of each row, the cache keeps for
    ``decode_step`` ("enc")."""
    tokens = torch.as_tensor(batch["tokens"])
    B, S = tokens.shape
    rows = _model_rows(model, ctx, B)
    pos, flash = _cp_positions(batch, cfg, B, S)
    Sm = S + cfg.meta_tokens
    cache = init_cache(cfg, B, max_len, ctx=ctx)
    encs = [None] * len(rows)
    if cfg.encoder_layers and enc is not None:
        encs = _placed_states(rows, enc, cfg)
        cache["enc"] = (enc, encs)
    elif cfg.encoder_layers:
        encs = _model_encode(rows, _split_rows(_need_frames(batch, cfg),
                                               len(rows)), cfg)
    bounds = _chunks(Sm, rows[0].tp)
    states = [_cp_inputs(row, tok, p, bounds, cfg)
              for row, tok, p in zip(rows, _split_rows(tokens, len(rows)),
                                     _split_rows(pos, len(rows)))]
    for li, window in enumerate(layer_windows(cfg)):
        lps = [row.whole_layer(li) for row in rows]
        for row, lp, st, e in zip(rows, lps, states, encs):
            st["x"], kv, ssm = _cp_layer(row, lp, st["x"], st["q_pos"],
                                         st["k_pos"], bounds, window, cfg,
                                         ctx, flash, e, cache=True)
            for name, t in zip(("k", "v"), kv or ()):
                pieces, boxes, _ = _cache_view(cache, row, name)
                for g in range(row.tp):
                    _write_kv(pieces[g], boxes[g], li, t[g], 0)
            for name in ("state", "conv") if ssm else ():
                # the state's heads (all of them where the fit keeps it
                # whole) and the whole conv rows on each device
                pieces, boxes, _ = _cache_view(cache, row, name)
                for g in range(row.tp):
                    pieces[g][li] = ssm[g][name][:, boxes[g][2]] \
                        if name == "state" else ssm[g][name]
        del lps
    last = next(g for g, (s, e) in enumerate(bounds) if e == Sm)
    logits = []
    for row, st in zip(rows, states):
        x_last = st["x"][last][:, -1:]
        logits.append(_tp_logits(row, on_devices(
            row.devices, lambda g: x_last.to(row.devices[g])), cfg))
    cache["idx"] = Sm
    return _on_first(logits, model.device), cache


def decode_step(params, token: Tensor, cache: Cache,
                cfg: ModelConfig, enc: Optional[Tensor] = None, ctx=None
                ) -> Tuple[Tensor, Cache]:
    """One decode step. token: (B, 1) -> (logits (B, 1, V), cache with
    idx + 1). The token sits at position idx (on all three M-RoPE
    streams; whisper adds row idx of its sinusoidal table); ``enc``,
    whisper's encoder states, feeds every layer's cross-attention (none
    without it, as in the reference). The cache's tensors are written in
    place and shared by the returned cache. A model held as shards takes
    ``prefill``'s cache of its path -- pieces over "model" (the
    tensor-parallel step, ``_model_decode``; ``enc`` read from the copies
    prefill placed on every device where it is the tensor prefill was
    given), or rows, each row on its device -- and returns the logits on
    the grid's first device in row order."""
    check_supported(cfg)
    model = as_sharded(params, cfg, ctx)
    path = serve_path(params, cfg, ctx)
    path_counts[path] += 1
    if path == "model":
        with torch.inference_mode():
            return _model_decode(model, token, cache, cfg,
                                 _grid_ctx(model, ctx), enc)
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
    pieces} of ``ctx``'s grid) takes ``serve_path``'s path. "model": the
    reference's context-parallel prefill (``_model_prefill``); the cache
    is ``init_cache(ctx=)``'s pieces (and, given ``enc``, its copies on
    every device of each row, "enc"). "rows": the batch is split over
    ``ctx``'s dp rows, each run on the row's first device; layer by
    layer, with the rows inner, each row gathers the layer onto its
    device (every row's copies queued before any row computes,
    models/sharded.py: ``gathered_rows``), runs it and drops it (a MoE
    layer's expert groups on the row's devices of each model index), so
    the cards run at once; the cache is {"idx", "rows": one cache a dp
    row, on the row's device}. Either way the logits return on the
    grid's first device in row order."""
    check_supported(cfg)
    model = as_sharded(params, cfg, ctx)
    path = serve_path(params, cfg, ctx)
    path_counts[path] += 1
    with torch.inference_mode():
        S = batch["tokens"].shape[1]
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        if path == "model":
            return _model_prefill(model, batch, cfg, max_len,
                                  _grid_ctx(model, ctx), enc)
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
