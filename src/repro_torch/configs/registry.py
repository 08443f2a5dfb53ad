"""Architecture registry (port of repro/configs/registry.py): --arch <id>
-> config and smoke config, the assigned input-shape set, its skip rule,
and meta-tensor stand-ins for every model input and the decode cache.

  * decode shapes run ``decode_step`` (one token + KV cache), not a train
    step
  * long_500k requires sub-quadratic attention -> SSM/hybrid only
  * hog_svm_coproc is the paper's own workload (batched window detection,
    launch/dryrun.py)

Meta tensors take the place of the reference's ``jax.ShapeDtypeStruct``:
a shape and a dtype, nothing allocated.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

import torch

from ..models.configs import ModelConfig

#: arch id -> family, in the reference's ARCH_IDS order
ARCH_FAMILY = {
    "llama4-scout-17b-a16e": "moe",
    "olmoe-1b-7b": "moe",
    "whisper-large-v3": "encdec",
    "internlm2-20b": "dense",
    "phi3-medium-14b": "dense",
    "qwen3-14b": "dense",
    "command-r-35b": "dense",
    "qwen2-vl-72b": "vlm",
    "mamba2-130m": "ssm",
    "hymba-1.5b": "hybrid",
}
ARCH_IDS = tuple(ARCH_FAMILY)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)
SHAPE_BY_NAME = {s.name: s for s in SHAPES}

META = torch.device("meta")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    """The full-width config of ``arch``, or its smoke-size one."""
    if arch == "hog_svm_coproc":
        raise ValueError("hog_svm_coproc is handled by repro_torch.core, "
                         "see launch/dryrun.py")
    if arch not in ARCH_FAMILY:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(
        f"{__package__}." + arch.replace("-", "_").replace(".", "p"))
    return mod.SMOKE if smoke else mod.CONFIG


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped). Encodes the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attn): 500k decode needs sub-quadratic attention"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec, smoke: bool = False
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input (no allocation): int32
    tokens, labels and (B, S, 3) M-RoPE positions, f32 encoder input or
    states, as the reference's."""
    B = 4 if smoke else shape.global_batch
    S = 32 if smoke else shape.seq_len
    i32 = torch.int32

    def f(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=META)

    specs: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = f((B, S), i32)
        if shape.kind == "train":
            specs["labels"] = f((B, S), i32)
        if cfg.mrope:
            specs["positions"] = f((B, S, 3), i32)
        if cfg.encoder_layers:
            specs["enc_input"] = f((B, cfg.encoder_ctx, cfg.d_model),
                                   torch.float32)
    else:  # decode: one new token against a cache of length seq_len
        specs["token"] = f((B, 1), i32)
        if cfg.encoder_layers:
            specs["enc_states"] = f((B, cfg.encoder_ctx, cfg.d_model),
                                    torch.float32)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, smoke: bool = False
                ) -> Dict[str, object]:
    """The decode-shape KV/SSM cache: ``models.model.init_cache`` on the
    meta device (its "idx" a Python int, 0)."""
    from ..models.model import init_cache
    B = 4 if smoke else shape.global_batch
    S = 64 if smoke else shape.seq_len
    return init_cache(cfg, B, S, device=META)
