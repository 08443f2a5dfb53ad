"""Window classification -- the port of repro/core/pipeline.py.

``classify_windows(params, windows)`` is the paper's co-processor op
(Fig. 6: RGB window -> HOG -> SVM -> {0, 1}) for a batch of windows.

Execution paths:
  * path="ref"     plain tensor stages (core/hog.py), mode per HOGConfig,
  * path="kernel"  the staged window kernels (hog_gradient, cell_hist,
                   block_norm) and the svm_scores kernel,
  * path="fused"   the fused window kernel and svm_scores.

Devices: a numpy input goes to ``resolve_device(device)`` -- CUDA unless
``device="cpu"``, RuntimeError without a GPU. A tensor input stays on
its own device, and tensor SVM parameters must be on it too (numpy ones
are moved there). On CUDA tensors the kernel paths launch their kernels
or raise; nothing falls back to the CPU.

``shard_over_data`` and ``detection_step_specs`` (mesh placement) are a
later slice of the port.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .detector import _same_device, resolve_device
from .hog import HOGConfig, PAPER_HOG
from .svm import SVMParams, svm_score

Tensor = torch.Tensor


def _windows_on(windows, device) -> Tensor:
    if isinstance(windows, Tensor):
        if device is not None and not _same_device(
                resolve_device(device), windows.device):
            raise ValueError(f"windows are on {windows.device}, but "
                             f"device={device!r} was asked for")
        return windows
    return torch.from_numpy(np.ascontiguousarray(windows)).to(
        resolve_device(device))


def _params_on(params, dev: torch.device) -> SVMParams:
    out = {}
    for k in ("w", "b"):
        v = params[k]
        if isinstance(v, Tensor):
            if not _same_device(v.device, dev):
                raise ValueError(f"SVM parameter {k!r} is on {v.device}, "
                                 f"the windows on {dev}")
            out[k] = v.to(torch.float32)
        else:
            out[k] = torch.as_tensor(np.asarray(v, np.float32), device=dev)
    return out


def extract_features(windows, cfg: HOGConfig = PAPER_HOG, path: str = "ref",
                     device=None) -> Tensor:
    """(B, 130, 66, 3) uint8 (or (B, H, W) gray) -> (B, 3780) descriptors,
    f32 (bf16 for feat_dtype="bf16"). Windows smaller than the configured
    geometry raise ValueError."""
    from .stages import window_descriptor
    return window_descriptor(_windows_on(windows, device), cfg, backend=path)


def classify_windows(params: SVMParams, windows, cfg: HOGConfig = PAPER_HOG,
                     path: str = "ref", device=None) -> Dict[str, Tensor]:
    """Full co-processor op: windows -> {"score": (B,) f32, "human": (B,)
    int32}. (Fig. 6 datapath.)"""
    windows = _windows_on(windows, device)
    svm = _params_on(params, windows.device)
    feats = extract_features(windows, cfg, path)
    if path in ("kernel", "fused"):
        from ..kernels import ops
        # the f32 weights, even against bf16 descriptors
        # (repro/core/pipeline.py:57)
        score = ops.svm_score_kernel(feats, svm["w"], svm["b"])
    elif cfg.feat_dtype == "bf16":
        # bf16 descriptors AND bf16 weights, f32 accumulation
        # (repro/core/pipeline.py:60-67); both upcast exactly, since a
        # bf16 torch.matmul would round its sum to bf16
        w16 = svm["w"].to(torch.bfloat16).to(torch.float32)
        score = torch.matmul(feats.to(torch.float32), w16) + svm["b"]
    else:
        score = svm_score(svm, feats)
    return {"score": score, "human": (score > 0).to(torch.int32)}
