"""Sharding rules: parameter and activation specs per grid and profile
(port of repro/sharding/rules.py).

Axis roles, as the reference's:
  "pod"   -- pure data parallelism across pods (only gradient reductions
             cross it)
  "data"  -- FSDP / ZeRO-3 weight-shard axis and batch axis
  "model" -- tensor parallelism (heads, FFN columns, MoE experts)

A spec is a tuple with one entry a dimension: None (replicated), an axis
name, or a tuple of two or more names (split over their product,
row-major) -- a ``PartitionSpec`` as ``tuple(P(...))`` reads it, a
one-name tuple written as the name. Specs are keyed by the port's
parameter names (``CausalLM.named_parameters()``: ``layers.<i>.attn.wq``).
The reference writes its rules for leaves stacked on a leading layer
axis, never sharded; the port keeps a leaf a layer, so a layer leaf's
spec is the reference's with that first entry dropped. Each rule's
regex is matched against the reference's path (``layers/attn/wq``), as
the reference matches it.

``param_shardings(grid, params, cfg)`` gives every parameter's
``Sharding``, its spec fitted to its shape (the reference's
``param_shardings`` as its dry run fits it); models/model.py's
``init_params``, convert.py's ``lm_params_from_numpy`` and
checkpoint/manager.py's ``restore`` make a model held as those shards
(models/sharded.py), which ``prefill``, ``decode_step``, ``encode`` and
``generate`` serve, and the trainer's ``state_shardings`` is built on it.

``Sharding(grid, spec)`` stands for the reference's ``NamedSharding``:
``shard(t)`` cuts a tensor into its pieces, one a grid device in
row-major order, each on its device (views on a grid of one device, a
copy of its own on distinct devices); ``gather(pieces)`` puts them back together. There is no
GSPMD: the code that runs on a grid (models/moe.py, train/) moves and
reduces the pieces itself.

Profiles: what each changes in the port --
  baseline  -- nothing (layout: batch over dp, sequence over "model").
  kv_heads  -- layout only (the decode cache's heads instead of its
               length over "model"; ``cache_specs_tree``; ``make_ctx``
               carries it as ``ctx.kv_shard_dim``).
  no_seq    -- the MoE path: without sequence sharding ``moe_ffn`` takes
               the replicated EP path, whose per-shard capacity differs
               from the all-to-all's, so drops (and numbers) may differ.
  perf      -- numbers: bf16 scores in ``_sdpa`` and ``banded_core``'s
               partial softmaxes, and windowed layers through
               ``banded_core``; its ``constrain_grads`` is layout only.
  flashgrad -- numbers: masked ``_sdpa`` as the reference's
               ``sdpa_flash`` (p rounded before the normalization); its
               ``constrain_grads`` is layout only.
Attention without a window over index-causal positions takes the flash
kernel under every profile (models/attention.py), so these change only
the masked paths: windows, M-RoPE image blocks.
"""
from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..launch.mesh import DeviceGrid
from ..models.configs import ModelConfig
from ..models.moe import ShardingCtx

Spec = Tuple[Any, ...]


def dp_axes(grid: DeviceGrid) -> Tuple[str, ...]:
    return tuple(a for a in grid.axis_names if a in ("pod", "data"))


def make_ctx(grid: DeviceGrid, seq_sharded: bool = True,
             profile=None) -> ShardingCtx:
    if profile is not None:
        kw = dict(seq_sharded=profile.seq_sharded,
                  bf16_scores=profile.bf16_scores,
                  banded=profile.banded_window,
                  flash_vjp=profile.flash_vjp,
                  kv_shard_dim=profile.kv_shard_dim)
    else:
        kw = dict(seq_sharded=seq_sharded)
    return ShardingCtx(grid=grid, dp_axes=dp_axes(grid), tp_axis="model",
                       **kw)


# ---------------------------------------------------------------------
# parameter rules: (path regex) -> spec, first match wins; written, as
# the reference's, for layer leaves stacked on a leading L axis
# ---------------------------------------------------------------------

_PARAM_RULES = [
    # embeddings: vocab x d_model, 2D-sharded
    (r"embed$", ("model", "data")),
    (r"lm_head$", ("data", "model")),
    (r"meta$", (None, None)),
    # attention / cross-attention projections
    (r"(attn|xattn)/w[qkv]$", (None, "data", "model")),
    (r"(attn|xattn)/wo$", (None, "model", "data")),
    (r"(attn|xattn)/[qk]_norm$", (None, None)),
    # dense MLP
    (r"mlp/w_(gate|up)$", (None, "data", "model")),
    (r"mlp/w_down$", (None, "model", "data")),
    # MoE: experts over 'model' (EP), d_model over 'data' (FSDP)
    (r"moe/router$", (None, "data", None)),
    (r"moe/w_(gate|up)$", (None, "model", "data", None)),
    (r"moe/w_down$", (None, "model", None, "data")),
    (r"moe/shared/w_(gate|up)$", (None, "data", "model")),
    (r"moe/shared/w_down$", (None, "model", "data")),
    # SSM
    (r"ssm/in_proj$", (None, "data", "model")),
    (r"ssm/out_proj$", (None, "model", "data")),
    (r"ssm/conv_[wb]$", (None, None)),
    (r"ssm/norm_scale$", (None, "model")),
    (r"ssm/(A_log|D_skip|dt_bias)$", (None, None)),
    # everything else (norm scales/biases): replicated
    (r".*", (None, None)),
]

_STACKS = ("layers", "enc_layers")


def ref_path(name: str) -> Tuple[str, bool]:
    """A parameter name as the reference's leaf path, and whether the
    reference stacks it: ``layers.3.attn.wq`` -> (``layers/attn/wq``,
    True), ``final_norm.scale`` -> (``final_norm/scale``, False)."""
    parts = name.split(".")
    if parts[0] in _STACKS:
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def _fit(spec: Spec, ndim: int) -> Spec:
    t = tuple(spec)
    if len(t) > ndim:          # rule written for stacked leaf; strip lead
        t = t[len(t) - ndim:]
    if len(t) < ndim:          # rule shorter: right-pad with None
        t = t + (None,) * (ndim - len(t))
    return t


def spec_for(name: str, ndim: int) -> Spec:
    """The spec of parameter ``name`` of ``ndim`` dimensions: the first
    rule whose regex the reference's path matches, fitted to the
    reference's leaf (one more dimension where it stacks layers), the
    stacked entry then dropped."""
    path, stacked = ref_path(name)
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            spec = _fit(spec, ndim + stacked)
            return spec[1:] if stacked else spec
    return (None,) * ndim


def _shapes(params) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of a ``CausalLM``, a {name: tensor} dict or a
    {name: shape} dict."""
    items = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items())
    return {n: tuple(v.shape) if hasattr(v, "shape") else tuple(v)
            for n, v in items}


def param_specs(params, cfg: ModelConfig) -> Dict[str, Spec]:
    """{parameter name: spec}, unfitted (``fit_tree`` drops the axes a
    dimension does not divide by)."""
    return {n: spec_for(n, len(s)) for n, s in _shapes(params).items()}


def param_shardings(grid: DeviceGrid, params, cfg: ModelConfig
                    ) -> Dict[str, "Sharding"]:
    """{parameter name: ``Sharding``} on ``grid``: ``param_specs`` fitted
    to the parameters' shapes by ``fit_tree`` (the reference's
    ``param_shardings`` with launch/dryrun.py's ``fitted_param_sh``).
    ``params``: a ``CausalLM``, a {name: tensor} dict or a {name: shape}
    dict (``models.model.param_shapes``), so a plan allocates nothing."""
    shapes = _shapes(params)
    return {n: Sharding(grid, sp) for n, sp in
            fit_tree(param_specs(shapes, cfg), shapes, grid).items()}


def _axis_list(entry) -> List[str]:
    if entry is None:
        return []
    return list(entry) if isinstance(entry, tuple) else [entry]


def _entry(axes: Sequence[str]):
    """Axis names as one spec entry: None, a name, or a tuple of names."""
    axes = tuple(axes)
    return None if not axes else (axes[0] if len(axes) == 1 else axes)


def axes_size(grid: DeviceGrid, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= grid.axis_sizes[a]
    return n


def fit_spec(spec: Spec, shape: Tuple[int, ...], grid: DeviceGrid) -> Spec:
    """Drop grid axes from a spec wherever the dimension does not divide
    by them (last axis first), so the dimension is replicated there (e.g.
    mamba2's in_proj columns, 3352, on a 16-way "model" axis, or a batch
    of 1)."""
    out = []
    for i, entry in enumerate(spec):
        ax = _axis_list(entry)
        while ax and shape[i] % axes_size(grid, ax) != 0:
            ax.pop()
        out.append(_entry(ax))
    return tuple(out)


def fit_tree(specs: Dict[str, Any], shapes: Dict[str, Any],
             grid: DeviceGrid) -> Dict[str, Any]:
    """fit_spec over a (nested) dict of specs and the matching shapes
    (tensors or shape tuples)."""
    out = {}
    for k, spec in specs.items():
        if isinstance(spec, dict):
            out[k] = fit_tree(spec, shapes[k], grid)
        else:
            s = shapes[k]
            out[k] = fit_spec(spec, tuple(s.shape) if hasattr(s, "shape")
                              else tuple(s), grid)
    return out


# ---------------------------------------------------------------------
# activation/batch rules
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Profile:
    name: str = "baseline"
    seq_sharded: bool = True        # shard sequence over 'model' (SP/CP)
    kv_shard_dim: str = "length"    # "length" | "heads" (decode cache)
    bf16_scores: bool = False       # half-width attention score tensors
    banded_window: bool = False     # block-banded sliding-window attn
    constrain_grads: bool = False   # grads pinned to the params' layout
    flash_vjp: bool = False         # LSE-saving attention (sdpa_flash)


PROFILES = {
    "baseline": Profile(),
    "kv_heads": Profile(name="kv_heads", kv_shard_dim="heads"),
    "no_seq": Profile(name="no_seq", seq_sharded=False),
    "perf": Profile(name="perf", bf16_scores=True, banded_window=True,
                    constrain_grads=True),
    "flashgrad": Profile(name="flashgrad", flash_vjp=True,
                         constrain_grads=True),
}


def batch_specs(cfg: ModelConfig, grid: DeviceGrid, kind: str,
                profile: Profile = PROFILES["baseline"]) -> Dict[str, Spec]:
    """Specs of the input batch's arrays for ``kind`` "train", "prefill"
    or "decode"."""
    dp = _entry(dp_axes(grid))
    seq = "model" if profile.seq_sharded else None
    if kind in ("train", "prefill"):
        sp = {"tokens": (dp, seq)}
        if kind == "train":
            sp["labels"] = (dp, seq)
        if cfg.mrope:
            sp["positions"] = (dp, seq, None)
        if cfg.encoder_layers:
            sp["enc_input"] = (dp, seq, None)
        return sp
    sp = {"token": (dp, None)}
    if cfg.encoder_layers:
        sp["enc_states"] = (dp, None, None)
    return sp


def cache_specs_tree(cfg: ModelConfig, grid: DeviceGrid,
                     profile: Profile = PROFILES["baseline"]
                     ) -> Dict[str, Spec]:
    """Specs of the cache (models/model.py:init_cache; leading L axis
    unsharded): the KV cache's length over "model" (the default), or its
    heads under ``kv_heads``. ``profile`` may be a ``ShardingCtx``, whose
    ``kv_shard_dim`` is its profile's."""
    dp = _entry(dp_axes(grid))
    out: Dict[str, Spec] = {"idx": ()}
    if cfg.has_attention:
        if profile.kv_shard_dim == "length":
            kv = (None, dp, "model", None, None)   # (L, B, S, K, hd)
        else:
            kv = (None, dp, None, "model", None)
        out["k"] = kv
        out["v"] = kv
    if cfg.has_ssm:
        out["state"] = (None, dp, "model", None, None)  # (L,B,H,N,P)
        out["conv"] = (None, dp, None, None)            # (L,B,k-1,C)
    return out


# ---------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor laid out on ``grid`` by ``spec`` (the reference's
    ``NamedSharding``): dimension i of the tensor is cut into as many
    blocks as its entry's axes have devices, and grid device (i, j, ...)
    holds the block its coordinates on those axes name (row-major over
    the entry's axes); every other axis replicates it."""

    grid: DeviceGrid
    spec: Spec

    def _axes(self, ndim: int) -> List[List[str]]:
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [_axis_list(e) for e in spec]

    def counts(self, ndim: int) -> Tuple[int, ...]:
        """The number of blocks along each dimension."""
        return tuple(axes_size(self.grid, ax) for ax in self._axes(ndim))

    def blocks(self, ndim: int) -> List[Tuple[int, ...]]:
        """The block each grid device holds, row-major over the grid."""
        names = self.grid.axis_names
        out = []
        for index in self.grid.indices():
            coord = dict(zip(names, index))
            b = []
            for ax in self._axes(ndim):
                c = 0
                for a in ax:
                    c = c * self.grid.axis_sizes[a] + coord[a]
                b.append(c)
            out.append(tuple(b))
        return out

    def block_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        counts = self.counts(len(shape))
        for n, c in zip(shape, counts):
            if n % c:
                raise ValueError(f"a dimension of {n} does not split into "
                                 f"{c} blocks (spec {self.spec}); fit the "
                                 f"spec first (fit_spec)")
        return tuple(n // c for n, c in zip(shape, counts))

    def owners(self, ndim: int) -> List[int]:
        """For each grid device (row-major), the first device that holds
        its block (a flat grid index): the block's primary copy."""
        first: Dict[Tuple[int, ...], int] = {}
        return [first.setdefault(b, i)
                for i, b in enumerate(self.blocks(ndim))]

    def slices(self, shape: Tuple[int, ...]) -> List[Tuple[slice, ...]]:
        """The block each grid device (row-major) holds of a tensor of
        ``shape``, as index slices."""
        bs = self.block_shape(tuple(shape))
        return [tuple(slice(i * n, (i + 1) * n) for i, n in zip(b, bs))
                for b in self.blocks(len(shape))]

    def shard(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t``'s pieces, one a grid device (row-major), each on its
        device. On a grid of one device (repeated) a piece is a view of
        ``t``; on distinct devices every piece is a copy of its own, so
        that dropping ``t`` frees it on its card."""
        copy = len(set(self.grid.flat)) > 1
        return [t[sl].to(dev, copy=copy)
                for dev, sl in zip(self.grid.flat, self.slices(t.shape))]

    def gather(self, pieces: Sequence[torch.Tensor], device=None,
               order: Optional[Sequence[int]] = None,
               lead: Tuple[int, ...] = (),
               at: Optional[Dict[int, int]] = None) -> torch.Tensor:
        """The whole tensor from its pieces, on ``device`` (the first
        piece's by default): each block read from its first holder in
        ``order`` (flat grid indices; row-major by default). ``lead``:
        only the part under those leading block indices (``(g,)``: block
        g of the first dimension), read from its holders alone; ``at``
        ({dimension: block}) likewise for any dimensions. A part that one
        piece holds whole, on ``device``, is that piece itself (no copy).
        Differentiable: each block's gradient flows back to the piece it
        was read from."""
        ndim = pieces[0].dim()
        dev = pieces[0].device if device is None else torch.device(device)
        blocks = self.blocks(ndim)
        first: Dict[Tuple[int, ...], int] = {}
        for i in (range(len(pieces)) if order is None else order):
            first.setdefault(blocks[i], i)
        counts = self.counts(ndim)
        fixed = dict(enumerate(lead))
        fixed.update(at or {})

        def assemble(prefix):
            d = len(prefix)
            if d == ndim:
                return pieces[first[prefix]].to(dev)
            bs = [fixed[d]] if d in fixed else range(counts[d])
            parts = [assemble(prefix + (b,)) for b in bs]
            return parts[0] if len(parts) == 1 else torch.cat(parts, d)

        return assemble(())

    def reads(self, shape: Tuple[int, ...], n_pieces: int,
              order: Optional[Sequence[int]] = None, lead: Tuple[int, ...] = (),
              at: Optional[Dict[int, int]] = None
              ) -> List[Tuple[int, Tuple[slice, ...]]]:
        """What ``gather`` of a tensor of whole ``shape`` from ``n_pieces``
        pieces reads: for each block, the flat index of the piece it reads
        and the slices of the gathered tensor that block fills."""
        ndim = len(shape)
        blocks = self.blocks(ndim)
        first: Dict[Tuple[int, ...], int] = {}
        for i in (range(n_pieces) if order is None else order):
            first.setdefault(blocks[i], i)
        bs = self.block_shape(tuple(shape))
        fixed = dict(enumerate(lead))
        fixed.update(at or {})
        ranges = [[fixed[d]] if d in fixed else range(c)
                  for d, c in enumerate(self.counts(ndim))]
        return [(first[b], tuple(slice(0, n) if d in fixed
                                 else slice(i * n, (i + 1) * n)
                                 for d, (i, n) in enumerate(zip(b, bs))))
                for b in itertools.product(*ranges)]

    def model_dim(self, ndim: int) -> Optional[int]:
        """The dimension split over "model" (the rules give it an entry of
        its own), or None where the tensor is replicated over it."""
        for d, ax in enumerate(self._axes(ndim)):
            if "model" in ax:
                return d if self.grid.axis_sizes["model"] > 1 else None
        return None


def cache_shardings(cfg: ModelConfig, grid: DeviceGrid, shapes,
                    profile=PROFILES["baseline"]) -> Dict[str, Sharding]:
    """{cache entry: ``Sharding``} of a cache of ``shapes`` ({entry: shape}
    of models/model.py:init_cache's tensors): ``cache_specs_tree`` fitted
    by ``fit_spec`` as the reference's dry run fits it -- an axis a
    dimension does not divide by is dropped, so a max_len that does not
    divide by "model" keeps the whole length on each model device.
    ``profile``: a ``Profile`` or a ``ShardingCtx`` (its
    ``kv_shard_dim``)."""
    specs = cache_specs_tree(cfg, grid, profile)
    return {k: Sharding(grid, fit_spec(specs[k], tuple(shape), grid))
            for k, shape in shapes.items()}


def device_bytes(shardings: Dict[str, Any], leaves: Dict[str, Any]
                 ) -> List[int]:
    """The bytes each grid device (row-major) holds of a (nested) dict of
    leaves laid out by the matching shardings; a leaf is a tensor or a
    (shape, dtype) pair, so nothing need be allocated."""
    total: Optional[List[int]] = None
    for k, sh in shardings.items():
        if isinstance(sh, dict):
            part = device_bytes(sh, leaves[k])
        else:
            leaf = leaves[k]
            shape, dtype = ((tuple(leaf.shape), leaf.dtype)
                            if hasattr(leaf, "shape") else
                            (tuple(leaf[0]), leaf[1]))
            n = 1
            for d in sh.block_shape(shape):
                n *= d
            nbytes = n * torch.empty((), dtype=dtype).element_size()
            part = [nbytes] * sh.grid.size
        total = part if total is None else [a + b
                                            for a, b in zip(total, part)]
    return total or []
