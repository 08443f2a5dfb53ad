"""Public wrappers around the window kernels -- the port of
repro/kernels/ops.py.

  * ``hog_descriptor_kernel`` -- the staged kernels (hog_gradient ->
    cell_hist -> block_norm),
  * ``hog_descriptor_fused``  -- the single fused window kernel,
  * ``svm_score_kernel``      -- the window scorer (svm_scores).

Both HOG wrappers are views over the one stage chain in core/stages.py
(window layout, "kernel" / "fused" backends).
"""
from __future__ import annotations

import torch

from ..core.hog import HOGConfig, PAPER_HOG
from ..core.stages import window_descriptor
from .svm_matmul import svm_scores

Tensor = torch.Tensor


def hog_descriptor_kernel(windows: Tensor,
                          cfg: HOGConfig = PAPER_HOG) -> Tensor:
    return window_descriptor(windows, cfg, backend="kernel")


def hog_descriptor_fused(windows: Tensor,
                         cfg: HOGConfig = PAPER_HOG) -> Tensor:
    return window_descriptor(windows, cfg, backend="fused")


def svm_score_kernel(feats: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    return svm_scores(feats, w, bias)
