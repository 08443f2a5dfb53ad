"""Carry weights and configuration across from the JAX reference.

  * ``svm_from_numpy({"w": (3780,), "b": ()}, device)`` -- the SVM leaves
    (numpy arrays, as the reference's checkpoint stores them) as f32
    tensors on ``device`` (CUDA unless the CPU is asked for);
  * ``config_from_reference_dict(d)`` -- a reference
    ``PipelineConfig.to_dict()`` as the port's PipelineConfig.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .api.config import PipelineConfig
from .core.detector import as_svm, resolve_device


def svm_from_numpy(leaves: Dict[str, Any], device=None
                   ) -> Dict[str, torch.Tensor]:
    """{"w": (3780,), "b": ()} numpy leaves -> f32 tensors on ``device``."""
    return as_svm(leaves, resolve_device(device))


def config_from_reference_dict(d: Dict[str, Any]) -> PipelineConfig:
    """A reference ``PipelineConfig.to_dict()`` (or its JSON) -> the
    port's PipelineConfig with the same fields."""
    return PipelineConfig.from_dict(d)
