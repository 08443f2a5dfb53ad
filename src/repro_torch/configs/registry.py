"""Architecture registry: arch id -> config and smoke config (port of
repro/configs/registry.py:get_config).

Every family of the reference runs: dense, MoE, SSM, hybrid,
encoder-decoder (whisper) and VLM (qwen2-vl). ``input_specs`` and
``cache_specs`` come with the dry-run port.
"""
from __future__ import annotations

import importlib

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


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    """The full-width config of ``arch``, or its smoke-size one."""
    if arch == "hog_svm_coproc":
        raise ValueError("hog_svm_coproc is handled by repro_torch.core")
    if arch not in ARCH_FAMILY:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(
        f"{__package__}." + arch.replace("-", "_").replace(".", "p"))
    return mod.SMOKE if smoke else mod.CONFIG
