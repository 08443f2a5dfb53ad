"""Carry weights and configuration across from the JAX reference.

  * ``svm_from_numpy({"w": (3780,), "b": ()}, device)`` -- the SVM leaves
    (numpy arrays, as the reference's checkpoint stores them), or K
    stacked heads ({"w": (K, 3780), "b": (K,)}), as f32 tensors on
    ``device`` (CUDA unless the CPU is asked for);
  * ``registry_from_numpy(heads)`` -- the reference's named heads (a
    reference ``HeadRegistry``, or any sequence of its heads: name,
    numpy params, threshold, metadata) as the port's HeadRegistry;
  * ``config_from_reference_dict(d)`` -- a reference
    ``PipelineConfig.to_dict()`` as the port's PipelineConfig;
  * ``model_config_from_reference_dict(d)`` -- a reference LM
    ``ModelConfig``'s fields (``dataclasses.asdict``) as the port's
    ModelConfig, ``dtype`` mapped to a torch dtype;
  * ``lm_params_from_numpy(leaves, cfg, device, shardings=None)`` -- the
    reference's LM parameter tree as numpy arrays (layer leaves stacked
    on axis 0; the encoder's on its own axis) as the port's ``CausalLM``
    on ``device`` (CUDA unless the CPU is asked for), or, with
    ``shardings``, as a ``ShardedLM`` read block by block onto its grid;
  * ``train_state_from_numpy(tree, cfg, device)`` and
    ``train_state_to_numpy(state, cfg)`` -- the reference's train state
    ({"params", "opt": {"step", "m", "v", "master"}} and, for its DDP
    trainer, "residual"; numpy leaves, layers stacked) into the port's
    (train/train_step.py: a trainable CausalLM and per-parameter f32
    trees keyed by parameter name), and back. The reference keeps one
    residual tree, replicated over its data axis; the port keeps one a
    shard, so it goes in to every shard (``shards``) and comes back
    from shard 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .api.config import PipelineConfig
from .core.detector import as_svm, resolve_device
from .core.heads import HeadRegistry
from .models.configs import ModelConfig
from .models.model import F32_LEAVES, CausalLM, from_leaves, trainable
from .models.sharded import ShardedLM


def svm_from_numpy(leaves: Dict[str, Any], device=None
                   ) -> Dict[str, torch.Tensor]:
    """{"w": (3780,), "b": ()} (or stacked {"w": (K, 3780), "b": (K,)})
    numpy leaves -> f32 tensors on ``device``."""
    return as_svm(leaves, resolve_device(device))


def _field(head, key: str, default=None):
    return head.get(key, default) if isinstance(head, dict) \
        else getattr(head, key, default)


def registry_from_numpy(heads) -> HeadRegistry:
    """The reference's heads, in order -- each with ``name``, ``params``
    ({"w": (F,), "b": ()} numpy leaves), ``threshold`` and ``metadata``,
    as attributes (a reference HeadRegistry iterates its SVMHeads) or
    dict keys -- as the port's HeadRegistry (host f32 parameters)."""
    reg = HeadRegistry()
    for h in heads:
        params = _field(h, "params")
        reg.add(_field(h, "name"), {"w": np.asarray(params["w"]),
                                    "b": np.asarray(params["b"])},
                _field(h, "threshold"), _field(h, "metadata"))
    return reg


def config_from_reference_dict(d: Dict[str, Any]) -> PipelineConfig:
    """A reference ``PipelineConfig.to_dict()`` (or its JSON) -> the
    port's PipelineConfig with the same fields."""
    return PipelineConfig.from_dict(d)


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _torch_dtype(x) -> torch.dtype:
    """A torch dtype from a torch dtype, a name, or a numpy-compatible
    dtype (a reference ``jnp.bfloat16`` is one, by way of ml_dtypes)."""
    if isinstance(x, torch.dtype):
        return x
    name = x if isinstance(x, str) else np.dtype(x).name
    if name not in _TORCH_DTYPES:
        raise ValueError(f"dtype {x!r} has no torch counterpart here")
    return _TORCH_DTYPES[name]


def model_config_from_reference_dict(d: Dict[str, Any]) -> ModelConfig:
    """A reference ModelConfig's fields (``dataclasses.asdict``, or their
    JSON) -> the port's ModelConfig with the same fields."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown ModelConfig fields {sorted(unknown)}")
    kw = dict(d)
    for key in ("mrope_sections", "global_attn_layers"):
        if key in kw:
            kw[key] = tuple(kw[key])
    if "dtype" in kw:
        kw["dtype"] = _torch_dtype(kw["dtype"])
    return ModelConfig(**kw)


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)                    # a writable, contiguous copy
    if a.dtype.name == "bfloat16":     # ml_dtypes: carry the bits over
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def lm_params_from_numpy(leaves: Dict[str, Any], cfg: ModelConfig,
                         device=None, shardings=None):
    """The reference's parameter tree ({"embed", "final_norm": {"scale"
    (, "bias")}, "layers": {"ln1", "ln2": {...}, "attn": {"wq", ...},
    "mlp" or "moe" or "ssm": {...}, "xattn", "ln_x", ...}, "lm_head",
    "meta", "enc_layers": {"ln1", "ln2", "attn", "mlp"}, "enc_norm"}) as
    numpy arrays, layers stacked on axis 0 -> the port's CausalLM on
    ``device``. Every leaf takes the config's dtype but the SSM's
    ``A_log``, ``D_skip`` and ``dt_bias``, which stay f32, as the
    reference keeps them.

    ``shardings`` ({name: Sharding}, sharding/rules.py:
    ``param_shardings``): a ``ShardedLM`` instead, each leaf's blocks
    read from its array straight onto their grid devices (one tensor a
    block and device), so no device holds a leaf whole; ``device`` then
    only names the grid's kind (ValueError if it differs)."""
    dev = resolve_device(device)
    if shardings is not None:
        return _sharded_from_numpy(leaves, cfg, dev, shardings)

    def conv(x, name=""):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        dtype = torch.float32 if name in F32_LEAVES else cfg.dtype
        return _tensor(x, dtype, dev)

    return from_leaves(cfg, conv(leaves))


def _sharded_from_numpy(leaves: Dict[str, Any], cfg: ModelConfig, dev,
                        shardings) -> ShardedLM:
    named = _named_leaves(leaves)
    pieces = {}
    for n, a in named.items():
        if n not in shardings:
            raise ValueError(f"{n}: a leaf the model does not have")
        sh = shardings[n]
        if sh.grid.flat[0].type != dev.type:
            raise ValueError(f"the grid's devices are {sh.grid.flat[0].type},"
                             f" device={dev} was asked for")
        dtype = torch.float32 if n.split(".")[-1] in F32_LEAVES \
            else cfg.dtype
        made, pieces[n] = {}, []
        for d, sl in zip(sh.grid.flat, sh.slices(np.shape(a))):
            block = (tuple((i.start, i.stop) for i in sl), d)
            if block not in made:
                made[block] = _tensor(np.asarray(a)[sl], dtype, d)
            pieces[n].append(made[block])
    return ShardedLM(cfg, shardings, pieces)


def _named_leaves(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A reference tree (layers stacked) as {parameter name: array}, the
    names ``CausalLM.named_parameters()`` gives: "layers.<i>.<path>" for
    row i of a stacked leaf (likewise "enc_layers."), "<path>" for the
    rest, each path "."-joined."""
    out: Dict[str, Any] = {}

    def walk(node, path, stack):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), stack)
        elif stack is None:
            out[".".join(path)] = node
        else:
            for i in range(np.shape(node)[0]):
                out[".".join((stack, str(i)) + path)] = node[i]

    for k, v in tree.items():
        if k in ("layers", "enc_layers"):
            walk(v, (), k)
        else:
            walk(v, (k,), None)
    return out


def _stacked(named: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The inverse of ``_named_leaves``: layer rows stacked on axis 0."""
    tree: Dict[str, Any] = {}
    rows: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for name, a in named.items():
        parts = name.split(".")
        if parts[0] in ("layers", "enc_layers"):
            rows.setdefault((parts[0],) + tuple(parts[2:]), {})[
                int(parts[1])] = a
        else:
            _put(tree, parts, a)
    for path, by_layer in rows.items():
        _put(tree, list(path), np.stack([by_layer[i]
                                         for i in range(len(by_layer))]))
    return tree


def _put(tree: Dict[str, Any], path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 widened to f32 (exact)."""
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def train_state_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                           device=None, shards: int = 1) -> Dict[str, Any]:
    """The reference's train state (numpy leaves) -> the port's on
    ``device``: trainable parameters, the step as a 0-d int32 tensor, m,
    v and master as f32 tensors by parameter name, and the residual tree
    (where given) copied into each of ``shards`` shards."""
    dev = resolve_device(device)
    params = trainable(lm_params_from_numpy(tree["params"], cfg, dev))
    names = [n for n, _ in params.named_parameters()]

    def by_name(sub):
        flat = _named_leaves(sub)
        if sorted(flat) != sorted(names):
            raise ValueError(f"the tree's leaves {sorted(flat)} are not the "
                             f"model's {sorted(names)}")
        return {n: _tensor(flat[n], torch.float32, dev) for n in names}

    o = tree["opt"]
    state = {"params": params, "opt": {
        "step": torch.tensor(int(np.asarray(o["step"])), dtype=torch.int32,
                             device=dev),
        "m": by_name(o["m"]), "v": by_name(o["v"]),
        "master": by_name(o["master"])}}
    if "residual" in tree:
        res = by_name(tree["residual"])
        state["residual"] = [{n: t.clone() for n, t in res.items()}
                             for _ in range(shards)]
    return state


def train_state_to_numpy(state: Dict[str, Any], cfg: ModelConfig
                         ) -> Dict[str, Any]:
    """The port's train state -> the reference's tree of numpy leaves
    (layers stacked; bf16 parameters as f32 arrays of the same values;
    the step int32; shard 0's residual)."""
    named = {n: _host(p) for n, p in state["params"].named_parameters()}
    o = state["opt"]
    tree = {"params": _stacked(named), "opt": {
        "step": np.asarray(int(o["step"]), np.int32),
        **{k: _stacked({n: _host(t) for n, t in o[k].items()})
           for k in ("m", "v", "master")}}}
    if "residual" in state:
        tree["residual"] = _stacked({n: _host(t) for n, t in
                                     state["residual"][0].items()})
    return tree
