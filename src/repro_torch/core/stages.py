"""The HOG stage chain per backend, dense layout -- the port of
repro/core/stages.py.

    grayscale -> gradients -> mag/bin -> cell_histograms -> block_normalize

Backends:
  * "ref"    -- plain tensor stages from core/hog.py,
  * "kernel" -- the dense gradient+histogram kernel, then the dense
               block-norm kernel (kernels/dense_grad_hist.py,
               kernels/dense_block_norm.py),
  * "fused"  -- the single dense fused kernel (kernels/fused_hog.py).

This slice ports the dense layout, the one the detector runs. The window
layout (a batch of 130x66 tiles through the window kernels) serves the
window-classification path and is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from . import numerics as N
from .hog import (HOGConfig, PAPER_HOG, _MAG_BIN_FAST,
                  block_normalize, cell_histograms,
                  gradients, grayscale)

Tensor = torch.Tensor

WINDOW_LAYOUT_LATER = ("window layout (window kernels, classify_windows): "
                       "a later slice of the port")


@dataclasses.dataclass(frozen=True)
class StageSet:
    """One backend's implementation of the dense chain. ``dense_fused``
    short-circuits the whole chain; else ``dense_grad_hist`` +
    ``dense_block_norm``; else (the ref backend) the per-stage
    callables, which are shape-agnostic."""

    name: str
    grad_mag_bin: Optional[Callable[[Tensor, HOGConfig],
                                    Tuple[Tensor, Tensor]]] = None
    cell_hist: Optional[Callable[[Tensor, Tensor, HOGConfig], Tensor]] = None
    block_norm: Optional[Callable[[Tensor, HOGConfig], Tensor]] = None
    dense_grad_hist: Optional[Callable[[Tensor, HOGConfig], Tensor]] = None
    dense_block_norm: Optional[Callable[[Tensor, HOGConfig], Tensor]] = None
    dense_fused: Optional[Callable[[Tensor, HOGConfig], Tensor]] = None


def _cast_feat(blocks: Tensor, cfg: HOGConfig) -> Tensor:
    if cfg.feat_dtype == "bf16" and blocks.dtype != torch.bfloat16:
        return blocks.to(torch.bfloat16)
    return blocks


def _ref_grad_mag_bin(gray: Tensor, cfg: HOGConfig) -> Tuple[Tensor, Tensor]:
    fx, fy = gradients(gray)
    return _MAG_BIN_FAST[N.spec_for(cfg).name](fx, fy, cfg.bins)


def _ref_cell_hist(mag: Tensor, b: Tensor, cfg: HOGConfig) -> Tensor:
    return cell_histograms(mag, b, cfg)


def _ref_block_norm(hist: Tensor, cfg: HOGConfig) -> Tensor:
    return block_normalize(hist, cfg, norm=N.spec_for(cfg).norm)


def _kernel_dense_grad_hist(gray: Tensor, cfg: HOGConfig) -> Tensor:
    from ..kernels.dense_grad_hist import dense_grad_hist
    return dense_grad_hist(gray, cell=cfg.cell, bins=cfg.bins,
                           mode=N.spec_for(cfg).kernel_mode)


def _kernel_dense_block_norm(hist: Tensor, cfg: HOGConfig) -> Tensor:
    from ..kernels.dense_block_norm import dense_block_norm
    out = dense_block_norm(hist, block=cfg.block, eps=cfg.eps,
                           mode=N.spec_for(cfg).norm)
    return _cast_feat(out, cfg)


def _kernel_dense_fused(gray: Tensor, cfg: HOGConfig) -> Tensor:
    from ..kernels.fused_hog import dense_fused_hog
    out = dense_fused_hog(gray, cell=cfg.cell, block=cfg.block,
                          bins=cfg.bins, eps=cfg.eps,
                          mode=N.spec_for(cfg).kernel_mode)
    return _cast_feat(out, cfg)


BACKENDS = {
    "ref": StageSet("ref", _ref_grad_mag_bin, _ref_cell_hist,
                    _ref_block_norm),
    "kernel": StageSet("kernel",
                       dense_grad_hist=_kernel_dense_grad_hist,
                       dense_block_norm=_kernel_dense_block_norm),
    "fused": StageSet("fused", dense_fused=_kernel_dense_fused),
}


def get_backend(backend: str) -> StageSet:
    try:
        return BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown stage backend {backend!r}; "
            f"expected one of {sorted(BACKENDS)}") from None


def run_stages(gray: Tensor, geom: HOGConfig, backend: str = "ref",
               layout: str = "dense") -> Tensor:
    """Run the chain on prepared gray (B, H, W) whose interior is a whole
    number of cells; ``geom`` is the geometry-adjusted config. Returns
    the normalized block grid (B, bh, bw, block_dim)."""
    if layout != "dense":
        raise NotImplementedError(WINDOW_LAYOUT_LATER)
    ss = get_backend(backend)
    if N.spec_for(geom).quantized:
        # the fixed datapath's entry seam (repro/core/stages.py:198-205):
        # gray snaps to whole levels, half to even, before any backend,
        # so the gradients are exact integers
        gray = torch.round(gray)
    if ss.dense_fused is not None:
        return ss.dense_fused(gray, geom)
    if ss.dense_grad_hist is not None:
        return ss.dense_block_norm(ss.dense_grad_hist(gray, geom), geom)
    mag, b = ss.grad_mag_bin(gray, geom)
    return ss.block_norm(ss.cell_hist(mag, b, geom), geom)


def _to_gray(x: Tensor) -> Tensor:
    gray = grayscale(x) if x.shape[-1] == 3 else x
    return gray.to(torch.float32)


def dense_blocks(image: Tensor, cfg: HOGConfig = PAPER_HOG,
                 backend: str = "ref") -> Tensor:
    """Dense layout: (..., H, W[, 3]) -> (..., BH, BW, block_dim).

    The gradient field is trimmed so it tiles into whole cells; the block
    grid is shared by every window position at cell stride.
    """
    gray = _to_gray(image)
    h, w = gray.shape[-2], gray.shape[-1]
    gh = (h - 2) // cfg.cell * cfg.cell
    gw = (w - 2) // cfg.cell * cfg.cell
    if gh < cfg.cell * cfg.block or gw < cfg.cell * cfg.block:
        raise ValueError(
            f"scene spatial shape {(h, w)} is too small for even one "
            f"{cfg.block}x{cfg.block}-cell block of {cfg.cell}px cells")
    gray = gray[..., : gh + 2, : gw + 2]
    geom = dataclasses.replace(cfg, window_h=gh + 2, window_w=gw + 2)
    lead = gray.shape[:-2]
    flat = gray.reshape((-1,) + tuple(gray.shape[-2:])).contiguous()
    out = run_stages(flat, geom, backend)
    return out.reshape(lead + tuple(out.shape[1:]))
