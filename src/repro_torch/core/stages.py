"""The HOG stage chain per backend and layout -- the port of
repro/core/stages.py.

    grayscale -> gradients -> mag/bin -> cell_histograms -> block_normalize

Backends:
  * "ref"    -- plain tensor stages from core/hog.py,
  * "kernel" -- staged kernels: per layout, the window kernels
               (kernels/hog_gradient.py, kernels/cell_hist.py,
               kernels/block_norm.py) or the dense gradient+histogram and
               block-norm kernels (kernels/dense_grad_hist.py,
               kernels/dense_block_norm.py),
  * "fused"  -- one fused kernel per layout (kernels/fused_hog.py:
               ``fused_hog`` for windows, ``dense_fused_hog`` for scenes).

Layouts:
  * window -- a batch of fixed windows, cropped to the configured
              geometry; the block grid collates to (..., n_features),
  * dense  -- a whole scene trimmed to whole cells; the block grid
              (..., BH, BW, 36) is scored by the detector.

Block normalization is window-independent, so the layouts agree wherever
a window tiles onto the scene's cell grid.
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

@dataclasses.dataclass(frozen=True)
class StageSet:
    """One backend's implementation of the chain. In the window layout
    ``fused`` short-circuits the whole chain, else the per-stage
    callables run. In the dense layout ``dense_fused`` short-circuits it,
    else ``dense_grad_hist`` + ``dense_block_norm``; a backend without
    dense variants (ref, whose stages are shape-agnostic) runs its
    per-stage callables on the scene."""

    name: str
    grad_mag_bin: Optional[Callable[[Tensor, HOGConfig],
                                    Tuple[Tensor, Tensor]]] = None
    cell_hist: Optional[Callable[[Tensor, Tensor, HOGConfig], Tensor]] = None
    block_norm: Optional[Callable[[Tensor, HOGConfig], Tensor]] = None
    fused: Optional[Callable[[Tensor, HOGConfig], Tensor]] = None
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


def _kernel_grad_mag_bin(gray: Tensor, cfg: HOGConfig
                         ) -> Tuple[Tensor, Tensor]:
    from ..kernels.hog_gradient import hog_gradient
    return hog_gradient(gray, mode=N.spec_for(cfg).kernel_mode)


def _kernel_cell_hist(mag: Tensor, b: Tensor, cfg: HOGConfig) -> Tensor:
    from ..kernels.cell_hist import cell_hist
    return cell_hist(mag, b, cell=cfg.cell, bins=cfg.bins)


def _kernel_block_norm(hist: Tensor, cfg: HOGConfig) -> Tensor:
    from ..kernels.block_norm import block_norm
    out = block_norm(hist, block=cfg.block, eps=cfg.eps,
                     mode=N.spec_for(cfg).norm)
    return _cast_feat(out, cfg)


def _kernel_fused(gray: Tensor, cfg: HOGConfig) -> Tensor:
    from ..kernels.fused_hog import fused_hog
    desc = fused_hog(gray, cell=cfg.cell, block=cfg.block, bins=cfg.bins,
                     eps=cfg.eps, mode=N.spec_for(cfg).kernel_mode)
    bh, bw = cfg.blocks_hw
    return _cast_feat(desc.reshape(desc.shape[0], bh, bw, cfg.block_dim),
                      cfg)


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
    "kernel": StageSet("kernel", _kernel_grad_mag_bin, _kernel_cell_hist,
                       _kernel_block_norm,
                       dense_grad_hist=_kernel_dense_grad_hist,
                       dense_block_norm=_kernel_dense_block_norm),
    "fused": StageSet("fused", fused=_kernel_fused,
                      dense_fused=_kernel_dense_fused),
}


def get_backend(backend: str) -> StageSet:
    try:
        return BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown stage backend {backend!r}; "
            f"expected one of {sorted(BACKENDS)}") from None


def run_stages(gray: Tensor, geom: HOGConfig, backend: str = "ref",
               layout: str = "window") -> Tensor:
    """Run the chain on prepared gray (B, H, W) whose interior is a whole
    number of cells; ``geom`` is the geometry-adjusted config. Returns
    the normalized block grid (B, bh, bw, block_dim). ``layout="dense"``
    takes the backend's scene kernels where it has them."""
    if layout not in ("window", "dense"):
        raise ValueError(f"unknown layout {layout!r}; expected 'window' or "
                         f"'dense'")
    ss = get_backend(backend)
    if N.spec_for(geom).quantized:
        # the fixed datapath's entry seam (repro/core/stages.py:198-205),
        # shared by both layouts: gray snaps to whole levels, half to
        # even, before any backend, so the gradients are exact integers
        gray = torch.round(gray)
    if layout == "dense":
        if ss.dense_fused is not None:
            return ss.dense_fused(gray, geom)
        if ss.dense_grad_hist is not None:
            return ss.dense_block_norm(ss.dense_grad_hist(gray, geom), geom)
    if ss.fused is not None:
        return ss.fused(gray, geom)
    mag, b = ss.grad_mag_bin(gray, geom)
    return ss.block_norm(ss.cell_hist(mag, b, geom), geom)


def validate_window(window: Tensor, cfg: HOGConfig) -> None:
    """Reject windows smaller than the configured detection window;
    larger ones are top-left-anchored and cropped."""
    spatial = tuple(window.shape[-3:-1]) if window.shape[-1] == 3 \
        else tuple(window.shape[-2:])
    if len(spatial) < 2 or spatial[0] < cfg.window_h \
            or spatial[1] < cfg.window_w:
        raise ValueError(
            f"window spatial shape {spatial} is smaller than the "
            f"configured detection window ({cfg.window_h}, {cfg.window_w}); "
            f"HOG expects (..., H>={cfg.window_h}, W>={cfg.window_w}[, 3])")


def _to_gray(x: Tensor) -> Tensor:
    gray = grayscale(x) if x.shape[-1] == 3 else x
    return gray.to(torch.float32)


def _flatten_batch(x: Tensor):
    """(..., H, W) -> ((B, H, W) contiguous, unflatten), so the kernels
    see one batch axis whatever the caller's leading dims; a cropped view
    is copied contiguous here, before any launch."""
    lead = tuple(x.shape[:-2])
    flat = x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()

    def unflatten(y: Tensor) -> Tensor:
        return y.reshape(lead + tuple(y.shape[1:]))

    return flat, unflatten


def window_blocks(windows: Tensor, cfg: HOGConfig = PAPER_HOG,
                  backend: str = "ref") -> Tensor:
    """Window layout: (..., H, W[, 3]) -> (..., bh, bw, block_dim)."""
    validate_window(windows, cfg)
    gray = _to_gray(windows)[..., : cfg.active_h + 2, : cfg.active_w + 2]
    geom = dataclasses.replace(cfg, window_h=cfg.active_h + 2,
                               window_w=cfg.active_w + 2)
    flat, unflatten = _flatten_batch(gray)
    return unflatten(run_stages(flat, geom, backend))


def window_descriptor(windows: Tensor, cfg: HOGConfig = PAPER_HOG,
                      backend: str = "ref") -> Tensor:
    """Window layout, collated: (..., H, W[, 3]) -> (..., n_features)."""
    blocks = window_blocks(windows, cfg, backend)
    return blocks.reshape(tuple(blocks.shape[:-3]) + (cfg.n_features,))


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
    flat, unflatten = _flatten_batch(gray)
    return unflatten(run_stages(flat, geom, backend, layout="dense"))
