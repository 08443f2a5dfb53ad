"""Intra-frame tile planning: the banded resize, the tile geometry and the
exact top-k merge behind the tiled detection path -- the port of
repro/core/tiling.py.

One frame's pyramid work is laid over the "tile" axis of a device grid
(launch/mesh.py): each tile computes the window positions it owns and a
LOCAL top-k over them, and ``merge_topk`` re-ranks the union so the
result equals the untiled program's (core/detector.py).

Two decompositions (DetectorConfig.tile_mode):

  * "slab"  -- row-slabs of each scale's score grid. A tile owning
    ``slab`` score rows recomputes a halo of (window_blocks + block - 2)
    cell rows = 122 px, so its descriptors are exact.
  * "scale" -- whole pyramid scales, greedily balanced over tiles by
    window count.

Equality with the untiled result rests on two facts:

  * the banded resize applies the exact resize taps as <= ~4
    multiply-adds PER OUTPUT ELEMENT, each product and each sum its own
    eager f32 op, t ascending (no fused multiply-add: the same rounding
    on the CPU and on the card), so any row slice of its output equals
    the same rows of the full output, and
  * the "matmul" resize stays exact under slab tiling only by running
    the full untiled product and slicing result rows afterwards.

``merge_topk`` orders the union by (-score, global flat index), the key
the untiled stable top-k sorts by, so one two-key sort reproduces the
untiled top-k, ties included, and one NMS pass over it the untiled keep
set.

Every function takes leading batch axes.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


# ------------------------------------------------- banded exact resize

@lru_cache(maxsize=256)
def band_weights(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """Band form of the (dst, src) resize weight matrix: per output row
    the first source tap ``lo[i]`` and the T-wide tap weights ``w[i, :]``
    (zero-padded; T the widest support over all rows). The weights are
    the matmul form's (detector._resize_weights), stored by support."""
    from .detector import _resize_weights
    full = _resize_weights(src, dst)                       # (dst, src)
    nz = np.abs(full) > 0
    assert nz.any(axis=1).all(), "resize weight row with empty support"
    first = nz.argmax(axis=1)
    last = src - 1 - nz[:, ::-1].argmax(axis=1)
    T = int((last - first + 1).max())
    w = np.zeros((dst, T), np.float32)
    rows = np.arange(dst)
    for t in range(T):
        col = first + t
        ok = col <= last
        w[ok, t] = full[rows[ok], col[ok]]
    return first.astype(np.int32), w


def extend_band(lo: np.ndarray, w: np.ndarray,
                ext: int) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-extend a band table to ``ext`` output rows: rows past the real
    dst have all-zero weights (and lo 0), so a tile whose slab runs past
    the scaled image computes exact zeros there -- rows that only ever
    feed masked (phantom) score rows."""
    if ext <= len(lo):
        return lo, w
    lo2 = np.zeros(ext, np.int32)
    lo2[: len(lo)] = lo
    w2 = np.zeros((ext, w.shape[1]), np.float32)
    w2[: len(w)] = w
    return lo2, w2


@lru_cache(maxsize=256)
def band_tensors(src: int, dst: int, ext: int,
                 device: torch.device) -> Tuple[Tensor, Tensor]:
    """``band_weights(src, dst)`` extended to ``ext`` rows, as (int64
    taps, f32 weights) tensors on ``device``, made once."""
    lo, w = extend_band(*band_weights(src, dst), ext)
    return (torch.from_numpy(lo.astype(np.int64)).to(device),
            torch.from_numpy(w).to(device))


def band_rows(g_pad: Tensor, lo: Tensor, w: Tensor) -> Tensor:
    """out[..., i, :] = sum_t w[i, t] * g_pad[..., lo[i] + t, :], t
    ascending, from the t = 0 product: each multiply and add its own
    f32 op, so any subset of output rows (sliced lo/w) gives the same
    rows of the full output. ``g_pad`` carries T trailing zero rows
    (only zero-weight taps reach them)."""
    acc = w[:, 0:1] * g_pad[..., lo, :]
    for t in range(1, w.shape[1]):
        acc = acc + w[:, t:t + 1] * g_pad[..., lo + t, :]
    return acc


def band_cols(g_pad: Tensor, lo: Tensor, w: Tensor) -> Tensor:
    """Column-axis version of band_rows: out[..., j] = sum_t
    g_pad[..., lo[j] + t] * w[j, t]. Same per-element contract."""
    acc = g_pad[..., lo] * w[:, 0]
    for t in range(1, w.shape[1]):
        acc = acc + g_pad[..., lo + t] * w[:, t]
    return acc


def resize_banded(g: Tensor, sh: int, sw: int) -> Tensor:
    """Banded resize (..., ph, pw) -> (..., sh, sw): rows, then columns,
    each axis through band_rows / band_cols over the exact resize taps,
    in f32. O(T) work per output element instead of the matmul form's
    O(src); the matmul form sums in another order (in f64 in the port),
    so the two modes differ in final ulps, each exactly tiling-invariant
    in its own way."""
    ph, pw = g.shape[-2:]
    if sh != ph:
        lo, w = band_tensors(ph, sh, sh, g.device)
        g = band_rows(torch.nn.functional.pad(g, (0, 0, 0, w.shape[1])),
                      lo, w)
    if sw != pw:
        lo, w = band_tensors(pw, sw, sw, g.device)
        g = band_cols(torch.nn.functional.pad(g, (0, w.shape[1])), lo, w)
    return g


# --------------------------------------------------- tile decomposition

def slab_rows(sph: int, fp: int) -> int:
    """Score rows each of fp tiles owns (ceil; the last tiles may own
    fewer real rows -- the overhang is masked as phantom rows)."""
    return -(-sph // fp)


def slab_pixel_rows(slab: int, hcfg) -> int:
    """Scaled-pixel rows one tile computes to produce ``slab`` exact score
    rows: (slab + window_blocks + block - 2) cell rows of ``cell`` px plus
    the 2-px gradient border -- a 122-px halo for the 130x66 window."""
    return (slab + hcfg.blocks_hw[0] + hcfg.block - 2) * hcfg.cell + 2


def scale_groups(per_scale: Sequence[Tuple[float, int, int]],
                 fp: int) -> Tuple[Tuple[int, ...], ...]:
    """Greedy balance of pyramid scales over fp tiles by window count:
    largest scale first into the least-loaded group. Groups may be empty
    when fp exceeds the scale count. Each group keeps ascending scale
    order, so its candidates stay in ascending global index."""
    loads = [0] * fp
    bins: List[List[int]] = [[] for _ in range(fp)]
    order = sorted(range(len(per_scale)),
                   key=lambda i: (-per_scale[i][1] * per_scale[i][2], i))
    for i in order:
        j = min(range(fp), key=lambda j: (loads[j], j))
        bins[j].append(i)
        loads[j] += per_scale[i][1] * per_scale[i][2]
    return tuple(tuple(sorted(b)) for b in bins)


# ------------------------------------------------------- exact merge

def merge_topk(scores: Tensor, idx: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Exact global top-k from stacked per-tile local top-k lists.

    scores / idx: (..., fp, k) local lists (scores descending, -inf
    padded; idx the global flat window index, n for phantom rows). An
    ascending sort on (-score, idx) -- a stable sort by idx, then a
    stable sort by -score -- gives the untiled top-k's order, equal
    scores to the lower flat index: a member of the global top-k has at
    most k-1 better candidates, hence at most k-1 in its own tile, so it
    is in the union. Negation is exact, so the scores come back bit for
    bit, -inf included."""
    lead = tuple(scores.shape[:-2])
    s = scores.reshape(lead + (-1,))
    i = idx.reshape(lead + (-1,))
    by_idx = torch.sort(i, dim=-1, stable=True).indices
    s, i = s.gather(-1, by_idx), i.gather(-1, by_idx)
    by_score = torch.sort(-s, dim=-1, stable=True).indices[..., :k]
    return s.gather(-1, by_score), i.gather(-1, by_score)
