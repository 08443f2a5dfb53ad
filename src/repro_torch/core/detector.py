"""Multi-scale sliding-window human detector, single-frame and batched
paths -- the port of repro/core/detector.py.

Per frame: grayscale and edge-pad to the 32-px bucket, resize each
pyramid scale as two matmuls over the exact ``jax.image.resize``
"linear" weights, build the dense HOG block grid (core/stages.py), score
it with one (BH*BW, 36) @ (36, 105) matmul plus 105 shifted adds, mask
windows outside the frame or below the threshold, take the top-k, run
the greedy NMS, and decode on the host against static box tables.

Block normalization is window-independent, so the scene's block grid is
computed once per scale and shared by every window. Everything up to the
decode stays on the detector's device; the "kernel" and "fused"
backends run the hand-written CUDA kernels there. Both numerics run:
float, and the fixed-point chain of the quant preset, which scores int8
block codes against int8 weight codes with an exact int32 product.

A bucket's program takes a leading batch axis: B frames of one bucket go
through one launch sequence, each kernel taking the whole batch (the
reference vmaps its program). ``detect_raw`` is a batch of one;
``detect_batch_raw`` schedules B frames in ``batch_chunk``-wide steps
(``_chunked_schedule``), the width measured at first use when it is 0
(``_autotune_chunk``).

Stacked heads: ``w`` (K, F) and ``b`` (K,) score K SVMs in one widened
(BH*BW, 36) @ (36, 105*K) product per level (one scorer launch for all K,
head-major columns), each head's plane collated in the one-head order;
threshold (``class_thresholds``), top-k and NMS run per head, and the
results carry a class axis (api/results.py).

``pyramid_resize="banded"`` resizes with the same taps as the matmul
form, applied per output element in f32 (core/tiling.py:resize_banded),
instead of the f64 products.

Several devices (launch/mesh.py grids; ``REPRO_TEST_DEVICES`` repeats one
device): with ``data_parallel != 1`` a batch is padded to a multiple of
the data axis with zero frames whose true size is (0, 0), split into one
sub-batch per device, each run by that device's copy of the program
under the same chunk schedule, and gathered back onto the detector's
device. With ``frame_parallel != 1`` a frame whose bucket area clears
``frame_parallel_min_area`` is tiled: each tile, on its own device of
the grid's row, takes its local top-k over the window positions it owns
(a row slab of every scale, or whole scales), and one exact merge
(``tiling.merge_topk``) and one NMS on the frame's device give the
untiled result bit for bit.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import svm_matmul as sm
from ..launch.mesh import (make_detection_mesh, make_tiled_mesh,
                           visible_devices)
from . import numerics as N
from . import quant
from .hog import HOGConfig, PAPER_HOG, grayscale, grayscale_fused
from .stages import BACKENDS, dense_blocks
from . import tiling

Tensor = torch.Tensor

@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Same fields and defaults as repro/core/detector.py:100, so a
    reference configuration loads unchanged."""

    hog: HOGConfig = PAPER_HOG
    scales: Tuple[float, ...] = (1.0, 0.8, 0.64)
    score_threshold: float = 0.0          # sign(D(x)) per eq. (7)
    nms_iou: float = 0.3
    max_detections: int = 0               # top-k size K; 0 = auto
    backend: str = "ref"                  # "ref" | "kernel" | "fused"
    shape_bucket: int = 32                # frames pad up to multiples
    batch_chunk: int = 0                  # frames a batch step; 0 = autotune
    data_parallel: int = 1                # devices on the batch axis:
    #                                       1 = one, 0 = every visible one
    frame_parallel: int = 1               # tiles of one frame: 1 = off,
    #                                       0 = every device left over
    tile_mode: str = "slab"               # "slab" (row slabs) | "scale"
    frame_parallel_min_area: int = 0      # bucket area below which a
    #                                       frame runs untiled
    pyramid_resize: str = "matmul"        # "matmul" (f64 products) |
    #                                       "banded" (f32 taps per pixel)
    class_thresholds: Tuple[float, ...] = ()  # per stacked head; () = all
    #                                             score_threshold


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Without a GPU, anything but an explicit CPU request raises;
    there is no silent fallback. ``"meta"`` allocates nothing (the dry
    run's traces, launch/dryrun.py). On the card, TF32 is switched off for
    cuBLAS and cuDNN so the resize matmuls stay full f32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                         f"('meta': shapes only, as the dry run traces)")
    return dev


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def check_supported(cfg: DetectorConfig) -> None:
    """Raise ValueError for settings no program runs."""
    if cfg.pyramid_resize not in ("matmul", "banded"):
        raise ValueError(
            f"DetectorConfig.pyramid_resize={cfg.pyramid_resize!r}: "
            f"expected 'matmul' or 'banded'")
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown stage backend {cfg.backend!r}; "
                         f"expected one of {sorted(BACKENDS)}")


def scene_blocks(gray: Tensor, cfg: HOGConfig, backend: str = "ref") -> Tensor:
    """Whole-scene normalized block grid: (H, W) -> (BH, BW, 36)."""
    return dense_blocks(gray, cfg, backend)


def score_blocks(blocks: Tensor, w: Tensor, b: Tensor,
                 cfg: HOGConfig = PAPER_HOG,
                 use_kernel: bool = False) -> Tensor:
    """Score the dense block grid: (..., BH, BW, 36) -> (..., PH, PW), or
    (..., K, PH, PW) for K stacked heads (w (K, F), b (K,)).

    score[i, j] = <blocks[i:i+15, j:j+7, :], W> + b, factored as ONE
    (N*BH*BW, 36) @ (36, 105) matmul of per-offset partial scores over
    every grid of the leading axes (the score_matmul kernel when
    ``use_kernel``) and 105 shifted adds in the reference's order: from
    zeros, offsets (di, dj) row-major, then b. bf16 blocks meet bf16
    weights, accumulated in f32.

    Fixed numerics (repro/core/detector.py:205-224): the block grid is
    already on its per-block int8 grid, so requantizing recovers the
    codes exactly; the weights quantize per offset column; the int8
    product (the score_matmul_int8 kernel when ``use_kernel``) is exact
    int32, and the rank-1 rescale has a fixed multiply order.

    Stacked heads (repro/core/detector.py:_score_blocks_multi): the
    weights lay out head-major, (36, 105*K), column k*105 + o being head
    k's offset o, and go through ONE kernel launch of K heads; int8
    weights quantize per column, so each head's codes are its one-head
    codes. Each head's plane is collated in the one-head order, then its
    bias added.
    """
    bh, bw = cfg.blocks_hw                              # 15, 7
    heads = w.shape[0] if w.dim() == 2 else 1
    lead = tuple(blocks.shape[:-3])
    BH, BW, bd = blocks.shape[-3:]
    flat = blocks.reshape(-1, bd).contiguous()
    if N.spec_for(cfg).quantized:
        q, s_rows = quant.quantize_blocks(flat)
        wt = w.reshape(heads * bh * bw, bd).T.to(torch.float32)
        wq, s_cols = quant.quantize_weight_columns(wt)
        wq = wq.contiguous()
        ci = (sm.score_matmul_int8(q, wq, heads) if use_kernel
              else sm.score_matmul_int8_plain(q, wq))
        contrib = quant.rescale_scores(ci, s_rows, s_cols)
    else:
        wt = w.reshape(heads * bh * bw, bd).T.to(blocks.dtype).contiguous()
        contrib = (sm.score_matmul(flat, wt, heads) if use_kernel
                   else sm.score_matmul_plain(flat, wt))
    if w.dim() == 1:
        return collate_scores(contrib.reshape(lead + (BH, BW, bh * bw)),
                              bh, bw) + b
    # (..., BH, BW, K, 105) -> (..., K, BH, BW, 105): a plane per head
    planes = contrib.reshape(lead + (BH, BW, heads, bh * bw)).movedim(-2, -4)
    return collate_scores(planes, bh, bw) + b[:, None, None]


def collate_scores(contrib: Tensor, bh: int, bw: int) -> Tensor:
    """Sum the per-offset partial scores into the window score map:
    (..., BH, BW, bh*bw) -> (..., BH-bh+1, BW-bw+1), from zeros, offsets
    (di, dj) row-major, as the reference accumulates them (bias not
    added); every leading index (frame, head) its own plane."""
    ph, pw = contrib.shape[-3] - bh + 1, contrib.shape[-2] - bw + 1
    out = torch.zeros(tuple(contrib.shape[:-3]) + (ph, pw),
                      dtype=torch.float32, device=contrib.device)
    for di in range(bh):
        for dj in range(bw):
            out = out + contrib[..., di:di + ph, dj:dj + pw, di * bw + dj]
    return out


def score_map(gray: Tensor, w: Tensor, b: Tensor, cfg: HOGConfig = PAPER_HOG,
              backend: str = "ref") -> Tensor:
    """Dense SVM score map at cell (8-px) stride. gray: (..., H, W) ->
    (..., PH, PW), or (..., K, PH, PW) for K stacked heads."""
    blocks = scene_blocks(gray, cfg, backend)
    return score_blocks(blocks, w, b, cfg, use_kernel=(backend != "ref"))


# ------------------------------------------------------------------- NMS

def matrix_iou(a: Tensor, b: Tensor) -> Tensor:
    """Pairwise IoU. a: (..., N, 4), b: (..., M, 4) as (y0, x0, y1, x1)
    -> (..., N, M)."""
    y0 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    x0 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    y1 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    x1 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(y1 - y0, min=0.0) * torch.clamp(x1 - x0, min=0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=1e-9)


def nms_keep(boxes: Tensor, scores: Tensor, iou_thr: float) -> Tensor:
    """Greedy NMS on the device over boxes sorted by descending score;
    entries with score -inf are invalid and never kept. boxes (..., K, 4),
    scores (..., K) -> keep (..., K), each leading index its own list.

    The reference runs a fori_loop over K whose step i keeps box i iff it
    is valid and no kept box j < i overlaps it by more than ``iou_thr``
    (vmapped over a batch). The loop-invariant part of that test,
    (iou > thr) & (j < i), is built once here; the sequential dependency
    stays a K-step loop of small tensor ops, each over every list at once
    (an NMS kernel is later work).
    """
    k = boxes.shape[-2]
    iou = matrix_iou(boxes, boxes)
    rank = torch.arange(k, device=boxes.device)
    sup = (iou > iou_thr) & (rank[:, None] < rank[None, :])
    # box axes first, so each step indexes dim 0 alone (the host's fast
    # path): valid[i] (...), sup_by_i[i][j] = sup[..., j, i], keep[j] (...)
    valid = torch.isfinite(scores).movedim(-1, 0)
    sup_by_i = sup.movedim(-1, 0).movedim(-1, 1).contiguous()
    keep = torch.zeros(valid.shape, dtype=torch.bool, device=boxes.device)
    for i in range(k):
        keep[i] = valid[i] & ~torch.any(keep & sup_by_i[i], dim=0)
    return keep.movedim(0, -1)


def _nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float) -> List[int]:
    """Greedy NMS on host -- the O(N^2) reference ``nms_keep`` is held
    against (a copy of repro/core/detector.py:332)."""
    order = np.argsort(-scores)
    keep: List[int] = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        yy0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        xx0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        yy1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        xx1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, yy1 - yy0) * np.maximum(0, xx1 - xx0)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3]
                                                   - boxes[rest, 1])
        iou = inter / np.maximum(a_i + a_r - inter, 1e-9)
        order = rest[iou <= iou_thr]
    return keep


def top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest values of the last axis and their indices, ties to
    the lower index (lax.top_k's order, which torch.topk does not
    promise)."""
    srt = torch.sort(x, dim=-1, descending=True, stable=True)
    return srt.values[..., :k], srt.indices[..., :k]


# ---------------------------------------------- per-bucket frame program

def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b if b > 1 else a


def _resolve_k(cfg: DetectorConfig, n: int) -> int:
    """Top-k size for n window positions: max_detections when set, else
    K = max(256, ceil(n / 256)) clamped to n."""
    if cfg.max_detections:
        return min(cfg.max_detections, n)
    return min(n, max(256, -(-n // 256)))


def _xla_column_sum(w: np.ndarray) -> np.ndarray:
    """Column sums of an (n, m) f32 array in XLA:CPU's order, read from
    its optimized HLO and emitted loops: while more than 32 rows remain,
    the rows are padded to a multiple of 32, floor(pad / 2) before and
    the rest after, and each window of 32 is summed in row order from
    zero (a reduce-window); the last 32 or fewer partial sums are then
    added in order from zero."""
    rows = list(w)
    while len(rows) > 32:
        n = len(rows)
        lo = (-(-n // 32) * 32 - n) // 2
        windows = []
        for start in range(-lo, n, 32):
            acc = np.zeros(w.shape[1:], np.float32)
            for r in rows[max(start, 0):start + 32]:
                acc = acc + r
            windows.append(acc)
        rows = windows
    total = np.zeros(w.shape[1:], np.float32)
    for r in rows:
        total = total + r
    return total


@lru_cache(maxsize=256)
def _resize_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) row-weight matrix of jax.image.resize's "linear" kernel
    (with its anti-aliasing taps on downscale), rebuilt op for op from
    jax/_src/image/scale.py:compute_weight_mat in f32 numpy:

      sample_f = (arange(dst) + 0.5) * inv_scale - 0.5
      x = |sample_f - arange(src)| / max(inv_scale, 1)
      w = max(0, 1 - x), columns divided by their sum unless the sum is
          <= 1000 * eps(f32), and columns whose sample lies outside
          [-0.5, src - 0.5] zeroed.

    The column sums follow XLA:CPU's reduction (``_xla_column_sum``), so
    the weights equal the reference's bit for bit at every size.
    """
    # counterpart: repro/core/detector.py:_resize_weights (the identity
    # through jax.image.resize)
    scale = dst / src                       # f64, as jax's _resize
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(dst, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(src, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)      # (src, dst)
    total = _xla_column_sum(w)[None, :]
    w = np.where(np.abs(total) > np.float32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample_f >= np.float32(-0.5)) & (sample_f <= np.float32(src - 0.5))
    w = np.where(inside[None, :], w, np.float32(0.0))
    return np.ascontiguousarray(w.T.astype(np.float32))


def _frame_hw(shape) -> Tuple[int, int]:
    """True (h, w) of a frame shape; raises on anything that is not an
    (H, W) gray or (H, W, 3) RGB frame."""
    if len(shape) == 3 and shape[-1] == 3:
        return int(shape[0]), int(shape[1])
    if len(shape) == 2:
        return int(shape[0]), int(shape[1])
    raise ValueError(
        f"expected an (H, W) gray or (H, W, 3) RGB frame, got shape "
        f"{tuple(shape)}")


class DecodeTables:
    """Static host-side decode geometry of one frame program: the
    flattened box/scale tables and the top-k size."""

    __slots__ = ("boxes", "scales", "k")

    def __init__(self, boxes: np.ndarray, scales: np.ndarray, k: int):
        self.boxes = boxes             # (N, 4) window boxes, frame coords
        self.scales = scales           # (N,) nominal pyramid scale per row
        self.k = k                     # top-k size


@dataclasses.dataclass(frozen=True)
class FrameProgram:
    """One bucket's multi-scale program + its static decode tables."""

    fn: Optional[Callable]         # (gray (B, ph, pw), w, b, ((h, w),) * B)
    #                                -> (top, idx, keep, n_valid), each
    #                                with the leading batch axis
    boxes: np.ndarray              # (N, 4) window boxes in frame coords
    scales: np.ndarray             # (N,) nominal pyramid scale per row
    n_positions: int               # N: window positions, all scales
    k: int                         # top-k size
    per_scale: Tuple[Tuple[float, int, int], ...] = ()
    #                (scale, score-map PH, score-map PW) per pyramid level
    tables: Optional[DecodeTables] = None
    pyramid: Optional[Callable] = None  # gray (..., ph, pw) -> levels
    level: Optional[Callable] = None    # (gray (B, ph, pw), i) -> level i
    inside: Optional[Callable] = None   # true sizes -> (1 or B, N) mask
    boxes_dev: Optional[Tensor] = None  # the box table on the device


def _frame_program(ph: int, pw: int, cfg: DetectorConfig,
                   device: torch.device) -> FrameProgram:
    """Build the program for padded frame shape (ph, pw) on ``device``:
    per-scale pyramid shapes, the flattened box table, the resize weights
    and K are fixed here, once; the returned ``fn`` runs a batch of
    frames of the bucket through one launch sequence, and nothing in it
    reads a device value back to the host."""
    hcfg = cfg.hog
    specs: List[Tuple[int, int, float]] = []
    for s in cfg.scales:
        sh, sw = int(ph * s), int(pw * s)
        if sh >= hcfg.window_h and sw >= hcfg.window_w:
            specs.append((sh, sw, s))

    cell = hcfg.cell
    wbh, wbw = hcfg.blocks_hw
    box_rows, scale_rows, per_scale = [], [], []
    for sh, sw, s in specs:
        gh, gw = (sh - 2) // cell * cell, (sw - 2) // cell * cell
        sbh, sbw = gh // cell - hcfg.block + 1, gw // cell - hcfg.block + 1
        sph, spw = sbh - wbh + 1, sbw - wbw + 1
        per_scale.append((s, sph, spw))
        sy, sx = sh / ph, sw / pw
        ys, xs = np.mgrid[0:sph, 0:spw].astype(np.float64)
        y0, x0 = ys * cell / sy, xs * cell / sx
        boxes = np.stack([y0, x0, y0 + hcfg.window_h / sy,
                          x0 + hcfg.window_w / sx], axis=-1)
        box_rows.append(boxes.reshape(-1, 4).astype(np.float32))
        scale_rows.append(np.full(sph * spw, s, np.float32))

    if not box_rows:
        empty4 = np.zeros((0, 4), np.float32)
        empty1 = np.zeros((0,), np.float32)
        return FrameProgram(None, empty4, empty1, 0, 0, (),
                            tables=DecodeTables(empty4, empty1, 0))

    boxes_tab = np.concatenate(box_rows)
    scale_tab = np.concatenate(scale_rows)
    n = len(boxes_tab)
    k = _resolve_k(cfg, n)
    boxes_dev = torch.from_numpy(boxes_tab).to(device)
    banded = cfg.pyramid_resize == "banded"
    # the weights in f64 (exact: they are f32 values); the resize sums in
    # f64 and rounds once to f32, so the card's GEMM and the CPU's give
    # the same level whatever order each sums in. The banded mode builds
    # its own tap tables (core/tiling.py)
    resize_w = {} if banded else {(sh, sw): (
        torch.tensor(_resize_weights(ph, sh), dtype=torch.float64,
                     device=device),
        torch.tensor(_resize_weights(pw, sw), dtype=torch.float64,
                     device=device))
        for sh, sw, _ in specs if (sh, sw) != (ph, pw)}
    inside_masks: Dict[Tuple[int, int], Tensor] = {}

    def inside_mask(h: int, w: int) -> Tensor:
        # windows must lie inside the TRUE frame; the reference adds 1e-4
        # to the f32 frame size in f32, and so does this host-side mask,
        # built once per true size and kept on the device
        m = inside_masks.get((h, w))
        if m is None:
            lim_h = np.float32(h) + np.float32(1e-4)
            lim_w = np.float32(w) + np.float32(1e-4)
            m = torch.from_numpy((boxes_tab[:, 2] <= lim_h)
                                 & (boxes_tab[:, 3] <= lim_w)).to(device)
            inside_masks[(h, w)] = m
        return m

    def inside(hws: Sequence[Tuple[int, int]]) -> Tensor:
        # (1, N) for a batch of one true size, else (B, N)
        if len(set(hws)) == 1:
            return inside_mask(*hws[0])[None]
        return torch.stack([inside_mask(*hw) for hw in hws])

    def resize(gray: Tensor, wy: Tensor, wx: Tensor) -> Tensor:
        # (B, ph, pw) -> (B, sh, sw): both products in f64 over the whole
        # batch, rounded to f32 once. Each output sums at most 4 x 4 taps
        # within a few f64 ulps of exact, so any GEMM order on any device
        # rounds it to the same f32 unless it lies that close to an f32
        # rounding boundary. An f32 GEMM rounds in its kernel's order,
        # which differs between cuBLAS and the CPU and between a batch's
        # shape and a frame's, and a last-ulp difference flips sector
        # bins and int8 codes, and with them kept boxes
        B = gray.shape[0]
        sh, sw = wy.shape[0], wx.shape[0]
        x = wy @ gray.to(torch.float64).permute(1, 0, 2).reshape(ph, B * pw)
        x = x.reshape(sh, B, pw).permute(1, 0, 2).reshape(B * sh, pw)
        return (x @ wx.T).to(torch.float32).reshape(B, sh, sw)

    def level(gray: Tensor, i: int) -> Tensor:
        # pyramid level i of a (B, ph, pw) gray, the whole frame
        sh, sw, _ = specs[i]
        if (sh, sw) == (ph, pw):
            return gray
        if banded:
            return tiling.resize_banded(gray, sh, sw)
        return resize(gray, *resize_w[(sh, sw)])

    def pyramid(gray: Tensor) -> List[Tensor]:
        lead = tuple(gray.shape[:-2])
        g = gray.reshape((-1, ph, pw))
        return [level(g, i).reshape(lead + (sh, sw))
                for i, (sh, sw, _) in enumerate(specs)]

    thresholds: Dict[int, Tensor] = {}

    def threshold(heads: int):
        # the per-head gates of stacked heads, (K, 1), made once
        if not heads:
            return cfg.score_threshold
        thr = thresholds.get(heads)
        if thr is None:
            if cfg.class_thresholds and len(cfg.class_thresholds) != heads:
                raise ValueError(
                    f"class_thresholds has {len(cfg.class_thresholds)} "
                    f"entries but the stacked params carry {heads} heads")
            thr = torch.tensor(cfg.class_thresholds
                               or (cfg.score_threshold,) * heads,
                               dtype=torch.float32, device=device)[:, None]
            thresholds[heads] = thr
        return thr

    def fn(gray: Tensor, w: Tensor, b: Tensor,
           hws: Sequence[Tuple[int, int]]):
        # stacked (K, F) heads add a class axis after the batch's: the
        # scores (B, K, N), one threshold, top-k and NMS per head
        B = gray.shape[0]
        heads = w.shape[0] if w.dim() == 2 else 0
        thr = threshold(heads)
        lead = (B, heads) if heads else (B,)
        parts = [score_map(g, w, b, hcfg, cfg.backend).reshape(lead + (-1,))
                 for g in pyramid(gray)]
        scores = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        mask = inside(hws)
        if heads:
            mask = mask[:, None]
        valid = mask & (scores > thr)
        masked = torch.where(valid, scores, float("-inf"))
        top, idx = top_k(masked, k)
        keep = nms_keep(boxes_dev[idx], top, cfg.nms_iou)
        return top, idx, keep, torch.sum(valid, dim=-1)

    return FrameProgram(fn, boxes_tab, scale_tab, n, k, tuple(per_scale),
                        tables=DecodeTables(boxes_tab, scale_tab, k),
                        pyramid=pyramid, level=level, inside=inside,
                        boxes_dev=boxes_dev)


# --------------------------------------------- intra-frame tiled program
# One frame's pyramid over the "tile" axis of a device grid: each tile
# computes the window positions it owns and its LOCAL top-k over them (the
# reference's _tile_local_fn, repro/core/detector.py:736), and one exact
# merge plus one NMS pass give the untiled result bit for bit
# (FrameDetector._tiled_step).

def _tile_local_fn(prog: FrameProgram, ph: int, pw: int, fp: int, d: int,
                   cfg: DetectorConfig) -> Callable:
    """Tile d of fp: (gray (B, ph, pw), w, b, hws) -> (top (B, k), idx
    (B, k), n_valid (B,)) on ``prog``'s device, where top / idx are the
    tile's local top-k over the global K (scores descending, -inf padded;
    idx the global flat window index, n for phantom rows).

    tile_mode "slab": every scale splits into row slabs of its score grid.
    Tile d computes hs = (slab + wbh + block - 2) * cell + 2 scaled-pixel
    rows from the cell-aligned offset d * slab * cell: its slab, the
    descriptor halo and the gradient border, so each owned descriptor is
    made of the pixels the untiled program uses. The banded taps are
    zero-extended so the last tile's overhang computes exact zeros, and
    overhang score rows become (-inf, n) phantoms; the matmul resize runs
    the untiled product (the same call on the same shapes) and slices
    its result rows, since a GEMM's summation order depends on the
    operands' shapes.

    tile_mode "scale": pyramid scales are balanced over tiles by window
    count (tiling.scale_groups; a group may be empty) and each tile runs
    its scales whole, with the untiled program's own level expression.

    Candidates are laid out scale by scale, owned rows first and phantom
    rows after, and the local top-k is the stable one (``top_k``), so
    equal scores keep ascending global index within a tile, as
    tiling.merge_topk needs.
    """
    if cfg.tile_mode not in ("slab", "scale"):
        raise ValueError(
            f"DetectorConfig.tile_mode={cfg.tile_mode!r}: expected "
            f"'slab' or 'scale'")
    hcfg = cfg.hog
    cell = hcfg.cell
    n, k = prog.n_positions, prog.k
    dev = prog.boxes_dev.device
    thr = cfg.score_threshold
    banded = cfg.pyramid_resize == "banded"
    specs = []
    off = 0
    for i, (s, sph, spw) in enumerate(prog.per_scale):
        specs.append((i, int(ph * s), int(pw * s), sph, spw, off))
        off += sph * spw
    assert off == n, (off, n)

    def finish(parts_s, parts_i, nv, B):
        padn = k - sum(p.shape[-1] for p in parts_s)
        if padn > 0:
            parts_s.append(torch.full((B, padn), float("-inf"), device=dev))
            parts_i.append(torch.full((B, padn), n, dtype=torch.int64,
                                      device=dev))
        top, pos = top_k(torch.cat(parts_s, dim=-1), k)
        return top, torch.cat(parts_i, dim=-1).gather(-1, pos), nv

    if cfg.tile_mode == "scale":
        group = [specs[i] for i in tiling.scale_groups(prog.per_scale,
                                                       fp)[d]]
        ranges = {i: torch.arange(base, base + sph * spw, device=dev)
                  for i, _, _, sph, spw, base in group}

        def local(gray: Tensor, w: Tensor, b: Tensor, hws):
            B = gray.shape[0]
            mask = prog.inside(hws)
            parts_s, parts_i = [], []
            nv = torch.zeros(B, dtype=torch.int64, device=dev)
            for i, _, _, sph, spw, base in group:
                flat = score_map(prog.level(gray, i), w, b, hcfg,
                                 cfg.backend).reshape(B, -1)
                valid = mask[:, base:base + sph * spw] & (flat > thr)
                parts_s.append(torch.where(valid, flat, float("-inf")))
                parts_i.append(ranges[i].expand(B, -1))
                nv = nv + torch.sum(valid, dim=-1)
            return finish(parts_s, parts_i, nv, B)

        return local

    plans = []
    for i, sh, sw, sph, spw, base in specs:
        slab = tiling.slab_rows(sph, fp)
        hs = tiling.slab_pixel_rows(slab, hcfg)
        # every tile's rows fit in L: the resize tables cover the last
        # tile's slab, so no slice is ever cut short (lax.dynamic_slice
        # would clamp its start there)
        L = max(sh, (fp - 1) * slab * cell + hs)
        poff = d * slab * cell
        assert poff + hs <= L, (poff, hs, L)
        rows = d * slab + torch.arange(slab, device=dev)
        idx = (base + rows[:, None] * spw
               + torch.arange(spw, device=dev)[None, :]).reshape(-1)
        owned = torch.repeat_interleave(rows < sph, spw)
        p = dict(i=i, L=L, poff=poff, hs=hs, owned=owned,
                 # the gather index: overhang rows of the last scale
                 # point past the table (JAX clamps there; torch raises)
                 at=idx.clamp(max=n - 1),
                 cand=torch.where(owned, idx, torch.full_like(idx, n)))
        if (sh, sw) == (ph, pw):
            p["mode"] = "direct"
        elif banded:
            lo_r, w_r = tiling.band_tensors(ph, sh, L, dev)
            p.update(mode="banded", lo=lo_r[poff:poff + hs],
                     w=w_r[poff:poff + hs],
                     col=(tiling.band_tensors(pw, sw, sw, dev)
                          if sw != pw else None))
        else:
            p.update(mode="matmul", sh=sh)
        plans.append(p)

    def slab_gray(gray: Tensor, p: dict) -> Tensor:
        poff, hs = p["poff"], p["hs"]
        if p["mode"] == "direct":
            return F.pad(gray, (0, 0, 0, p["L"] - ph))[:, poff:poff + hs]
        if p["mode"] == "banded":
            g_pad = F.pad(gray, (0, 0, 0, p["w"].shape[1]))
            gs = tiling.band_rows(g_pad, p["lo"], p["w"])
            if p["col"] is not None:
                lo_c, w_c = p["col"]
                gs = tiling.band_cols(F.pad(gs, (0, w_c.shape[1])), lo_c, w_c)
            return gs
        # the untiled expression verbatim, then its result rows
        gs = F.pad(prog.level(gray, p["i"]), (0, 0, 0, p["L"] - p["sh"]))
        return gs[:, poff:poff + hs]

    def local(gray: Tensor, w: Tensor, b: Tensor, hws):
        B = gray.shape[0]
        mask = prog.inside(hws)
        parts_s, parts_i = [], []
        nv = torch.zeros(B, dtype=torch.int64, device=dev)
        for p in plans:
            flat = score_map(slab_gray(gray, p), w, b, hcfg,
                             cfg.backend).reshape(B, -1)
            valid = p["owned"] & mask[:, p["at"]] & (flat > thr)
            parts_s.append(torch.where(valid, flat, float("-inf")))
            parts_i.append(p["cand"].expand(B, -1))
            nv = nv + torch.sum(valid, dim=-1)
        return finish(parts_s, parts_i, nv, B)

    return local


def _prep_batch(frames: Tensor, h: int, w: int, ph: int, pw: int) -> Tensor:
    """Grayscale (RGB input only) and edge-pad a (B, h, w[, 3]) stack to
    its bucket, frame by frame as the reference's vmapped prep. The gray
    is the reference's jitted luma (``grayscale_fused``: its two fused
    multiply-adds, exact for uint8 frames), on the frames' device.
    Replicate padding keeps downscaling from bleeding zeros into the last
    valid windows near the pad seam."""
    g = (grayscale_fused(frames) if frames.dim() == 4
         else frames.to(torch.float32))
    if (ph, pw) != (h, w):
        # F.pad's replicate mode wants a channel dim
        g = F.pad(g[:, None], (0, pw - w, 0, ph - h), mode="replicate")[:, 0]
    return g


def _prep_frame(frame: Tensor, h: int, w: int, ph: int, pw: int) -> Tensor:
    """One (h, w[, 3]) frame through ``_prep_batch``: (ph, pw) gray."""
    return _prep_batch(frame[None], h, w, ph, pw)[0]


def _batch_fn(step: Callable, h: int, w: int, ph: int, pw: int,
              batch: int, chunk: int) -> Callable:
    """A bucket's ``step`` (a program's ``fn``, or a tiled step) over raw
    (batch, h, w[, 3]) frames, prep included, in ``chunk``-wide steps
    (``_chunked_schedule``)."""
    def one(frames: Tensor, wv: Tensor, bv: Tensor, hws):
        return step(_prep_batch(frames, h, w, ph, pw), wv, bv, hws)

    return _chunked_schedule(one, max(1, chunk), batch)


def _chunked_schedule(one: Callable, chunk: int, batch: int) -> Callable:
    """The batch schedule of repro/core/detector.py:603: chunk >= batch
    is one wide step over every frame; otherwise chunk-wide steps in
    order and a last step of the remainder, as lax.map(batch_size=chunk)
    runs them (chunk 1: frame by frame), their outputs concatenated."""
    if chunk >= batch:
        return one

    def fn(frames: Tensor, wv: Tensor, bv: Tensor, hws):
        steps = [one(frames[i:i + chunk], wv, bv, hws[i:i + chunk])
                 for i in range(0, batch, chunk)]
        return tuple(torch.cat(parts) for parts in zip(*steps))

    return fn


# ------------------------------------------------- batch-chunk autotune
# The first detect_batch on a new (true-shape, bucket, B, frame layout)
# tuple with batch_chunk 0 times each candidate schedule on zero frames
# of the caller's layout (one warm-up, then the best of 3, the device
# synchronized around each run), keeps the fastest for the process and
# on disk (core/autotune_cache.py), and reports every decision through
# autotune_report() -- as repro/core/detector.py:1039-1130 does.

_AUTOTUNE: dict = {}
_AUTOTUNE_PROBE_ITERS = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _autotune_chunk(build: Callable[[int], Callable], h: int, w: int,
                    ph: int, pw: int, batch: int, cfg: DetectorConfig,
                    frame_shape: Tuple[int, ...], frame_dtype: torch.dtype,
                    device: torch.device, heads: int = 0, dp: int = 1,
                    fp: int = 1) -> int:
    """The chunk of the (padded) ``batch``'s schedule: ``build(chunk)``
    is the program the batch takes (routed over dp x fp devices), so the
    probe times exactly what the call will run."""
    import time

    from . import autotune_cache
    dtype = str(frame_dtype).replace("torch.", "")
    layout = f"{'rgb' if len(frame_shape) == 4 else 'gray'}-{dtype}"
    # the reference's key (the resolved data and tile axes; heads: 0 for
    # one (F,) head, K for stacked (K, F) heads), then the device type:
    # one process may run detectors on the card and on the CPU
    key = (h, w, ph, pw, batch, cfg, layout, dp, fp, heads, device.type)
    hit = _AUTOTUNE.get(key)
    if hit is not None:
        autotune_cache.note_memory_hit()
        return hit["chunk"]
    # under sharding the chunk schedules each device's local sub-batch
    local = batch // dp
    candidates = sorted({1, local} | ({4} if 1 < 4 < local else set()))
    if len(candidates) == 1:
        _AUTOTUNE[key] = {"chunk": candidates[0], "probe_ms": {}}
        return candidates[0]
    dkey = autotune_cache.entry_key(_autotune_key_str(key), cfg)
    disk = autotune_cache.lookup(dkey)
    if disk is not None and disk["chunk"] in candidates:
        _AUTOTUNE[key] = {**disk, "source": "disk"}
        return disk["chunk"]
    frames = torch.zeros(frame_shape, dtype=frame_dtype, device=device)
    wv = torch.zeros((heads, cfg.hog.n_features) if heads
                     else cfg.hog.n_features, dtype=torch.float32,
                     device=device)
    bv = torch.zeros((heads,) if heads else (), dtype=torch.float32,
                     device=device)
    hws = ((h, w),) * batch
    probe_ms = {}
    for c in candidates:
        fn = build(c)
        fn(frames, wv, bv, hws)                               # warm-up
        _sync(device)
        best = float("inf")
        for _ in range(_AUTOTUNE_PROBE_ITERS):
            t0 = time.perf_counter()
            fn(frames, wv, bv, hws)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        probe_ms[c] = best * 1e3
    chunk = min(probe_ms, key=probe_ms.get)
    _AUTOTUNE[key] = {"chunk": chunk, "probe_ms": probe_ms,
                      "source": "probe"}
    autotune_cache.store(dkey, chunk, probe_ms)
    return chunk


def _autotune_key_str(k: tuple) -> str:
    mesh = f"data:{k[7]}" + (f",tile:{k[8]}" if k[8] > 1 else "")
    heads = f" heads:{k[9]}" if k[9] else ""
    return (f"{k[0]}x{k[1]}->{k[2]}x{k[3]} B={k[4]} mesh={mesh}{heads} "
            f"[{k[6]}] on {k[10]}")


def autotune_report() -> dict:
    """Chosen detect_batch schedules, keyed by the probed geometry, frame
    layout and device: {"HxW->PHxPW B=n mesh=data:1 [rgb-uint8] on cuda":
    {"chunk": c, "probe_ms": {candidate: ms}, "source": "probe" or
    "disk"}}."""
    return {_autotune_key_str(k): dict(v) for k, v in _AUTOTUNE.items()}


def as_svm(svm, device: torch.device,
           n_features: int = PAPER_HOG.n_features) -> Dict[str, Tensor]:
    """{"w": (F,), "b": ()} -- or K stacked heads, {"w": (K, F), "b":
    (K,)} -- numpy arrays or tensors -> f32 tensors on ``device``."""
    w = torch.as_tensor(svm["w"], dtype=torch.float32).to(device)
    b = torch.as_tensor(svm["b"], dtype=torch.float32).to(device)
    if w.dim() == 2 and w.shape[0] >= 1 and w.shape[1] == n_features \
            and tuple(b.shape) == (w.shape[0],):
        return {"w": w.contiguous(), "b": b.contiguous()}
    if tuple(w.shape) != (n_features,) or b.numel() != 1:
        raise ValueError(f"expected w ({n_features},) and b (), or stacked "
                         f"w (K, {n_features}) and b (K,), got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    return {"w": w, "b": b.reshape(())}


def _empty_tables() -> DecodeTables:
    return DecodeTables(np.zeros((0, 4), np.float32),
                        np.zeros((0,), np.float32), 0)


class FrameDetector:
    """Reusable handle: SVM params + config -> per-frame detections.

    Builds one program per frame-shape bucket on first use and runs a
    frame, or a batch of frames of one bucket, through it; only the
    final box decode touches host numpy. Runs on CUDA unless
    ``device="cpu"``; raises RuntimeError when no GPU is present and the
    CPU was not asked for.

    Stacked (K, F) params score K heads in one widened product;
    ``heads`` is K (0 for one (F,) head) and ``classes`` names them
    ("head0", ... by default), riding into every Detections it builds so
    decoded boxes carry class_id and label.
    """

    def __init__(self, svm, cfg: Optional[DetectorConfig] = None,
                 device=None, classes: Optional[Sequence[str]] = None):
        self.cfg = DetectorConfig() if cfg is None else cfg
        check_supported(self.cfg)
        self.device = resolve_device(device)
        self.svm = as_svm(svm, self.device, self.cfg.hog.n_features)
        self.heads = int(self.svm["w"].shape[0]) \
            if self.svm["w"].dim() == 2 else 0
        if classes is not None and self.heads \
                and len(classes) != self.heads:
            raise ValueError(
                f"{len(classes)} class names for {self.heads} heads")
        self.classes = tuple(classes) if classes is not None else (
            tuple(f"head{i}" for i in range(self.heads))
            if self.heads else None)
        self._programs: Dict[Tuple[int, int], FrameProgram] = {}
        self.program_stats = {"hits": 0, "misses": 0}
        # the multi-device paths: each device's copy of a bucket's
        # program, the tiled steps, and the device grids
        self._device_programs: Dict[tuple, FrameProgram] = {}
        self._tiled_steps: Dict[tuple, Callable] = {}
        self._grids: Dict[Tuple[int, int], tuple] = {}

    def program_for(self, h: int, w: int) -> Tuple[FrameProgram, int, int]:
        b = max(1, self.cfg.shape_bucket)
        ph, pw = _round_up(h, b), _round_up(w, b)
        prog = self._programs.get((ph, pw))
        if prog is None:
            self.program_stats["misses"] += 1
            prog = _frame_program(ph, pw, self.cfg, self.device)
            self._programs[(ph, pw)] = prog
        else:
            self.program_stats["hits"] += 1
        return prog, ph, pw

    def bucket_for(self, frame) -> Tuple[int, int]:
        """Padded-bucket shape a frame would run under; raises ValueError
        on malformed shapes."""
        h, w = _frame_hw(tuple(frame.shape))
        _, ph, pw = self.program_for(h, w)
        return ph, pw

    # ------------------------------------------- devices, grids, tiles
    def _resolve_dp(self) -> int:
        """cfg.data_parallel as a device count (repro/core/detector.py:632):
        1 stays 1 without a device query, 0 is every visible device
        (launch/mesh.py:visible_devices), and more than the host has
        raises ValueError."""
        dp = self.cfg.data_parallel
        if dp == 1:
            return 1
        n = len(visible_devices(self.device))
        if dp == 0:
            return n
        if not 1 <= dp <= n:
            raise ValueError(
                f"DetectorConfig.data_parallel={dp}: the host has {n} "
                f"visible device(s) (visible_devices()); use 0 (= all) or "
                f"a value in [1, {n}]")
        return dp

    def _resolve_fp(self, dp: Optional[int] = None) -> int:
        """cfg.frame_parallel as a tile count (repro/core/detector.py:704):
        1 stays 1, 0 is every device left over after the data axis (at
        least 1), and an explicit n must fit beside the data axis."""
        fp = self.cfg.frame_parallel
        if fp == 1:
            return 1
        if dp is None:
            dp = self._resolve_dp()
        n = len(visible_devices(self.device))
        if fp == 0:
            return max(1, n // dp)
        if fp < 1 or dp * fp > n:
            raise ValueError(
                f"DetectorConfig.frame_parallel={fp}: with data_parallel="
                f"{dp} the host's {n} visible device(s) allow at most "
                f"{max(1, n // dp)} tiles; use 0 (= all remaining) or a "
                f"value in [1, {max(1, n // dp)}]")
        return fp

    @property
    def data_devices(self) -> int:
        """Devices of the batch ("data") axis: 1 on one device. The
        service scales its per-dispatch frame target by it."""
        return self._resolve_dp()

    @property
    def frame_devices(self) -> int:
        """Devices of the intra-frame ("tile") axis: 1 when tiling is off.
        Whether a frame runs tiled also depends on its bucket's area
        (``_tiled_for``)."""
        return self._resolve_fp()

    def _tiled_for(self, ph: int, pw: int, dp: int = 1) -> int:
        """Tiles a (ph, pw)-bucket frame runs under: the resolved tile
        axis when the bucket's area clears frame_parallel_min_area, else
        1 (the untiled program)."""
        fp = self._resolve_fp(dp)
        if fp > 1 and ph * pw >= self.cfg.frame_parallel_min_area:
            if self.heads:
                raise ValueError(
                    "multi-head (stacked) params do not compose with "
                    "frame_parallel tiling yet; run the stacked heads "
                    "with frame_parallel=1 (the data axis still shards)")
            return fp
        return 1

    def _grid(self, dp: int, fp: int) -> tuple:
        """dp rows of fp devices each: the data axis's devices
        (launch/mesh.py:make_detection_mesh) or, tiled, the rows of
        make_tiled_mesh."""
        rows = self._grids.get((dp, fp))
        if rows is None:
            if fp == 1:
                rows = tuple((d,) for d in
                             make_detection_mesh(dp, self.device).devices)
            else:
                rows = make_tiled_mesh(dp, fp, self.device).devices
            self._grids[(dp, fp)] = rows
        return rows

    def _program_on(self, ph: int, pw: int,
                    device: torch.device) -> FrameProgram:
        """The (ph, pw) bucket's program on ``device``: the detector's own
        there (built by ``program_for``), else a copy made once."""
        if _same_device(device, self.device):
            return self._programs[(ph, pw)]
        key = (ph, pw, device)
        prog = self._device_programs.get(key)
        if prog is None:
            prog = _frame_program(ph, pw, self.cfg, device)
            self._device_programs[key] = prog
        return prog

    def _tiled_step(self, ph: int, pw: int, fp: int,
                    devices: tuple) -> Callable:
        """One frame batch's tiled program over ``devices`` (a grid row):
        gray (B, ph, pw) -> (top, idx, keep, n_valid) on devices[0], the
        frames' device. Tile d runs on devices[d] (tiles sharing a device
        run one after another); the merge (tiling.merge_topk) and the one
        NMS pass run on devices[0], as repro/core/detector.py:947."""
        step = self._tiled_steps.get((ph, pw, devices))
        if step is not None:
            return step
        home = devices[0]
        prog = self._program_on(ph, pw, home)
        tiles = [(dev, _tile_local_fn(self._program_on(ph, pw, dev), ph, pw,
                                      fp, d, self.cfg))
                 for d, dev in enumerate(devices)]
        last = prog.n_positions - 1

        def step(gray: Tensor, wv: Tensor, bv: Tensor, hws):
            outs = [local(gray.to(dev), wv.to(dev), bv.to(dev), hws)
                    for dev, local in tiles]
            top, idx = tiling.merge_topk(
                torch.stack([o[0].to(home) for o in outs], dim=-2),
                torch.stack([o[1].to(home) for o in outs], dim=-2), prog.k)
            # a merged phantom (idx n) is -inf and never kept; clamp its
            # gather as JAX does
            keep = nms_keep(prog.boxes_dev[idx.clamp(max=last)], top,
                            self.cfg.nms_iou)
            nv = torch.stack([o[2].to(home) for o in outs]).sum(0)
            return top, idx, keep, nv

        self._tiled_steps[(ph, pw, devices)] = step
        return step

    def _batch_program(self, prog: FrameProgram, h: int, w: int, ph: int,
                       pw: int, batch: int, dp: int, fp: int,
                       chunk: int) -> Callable:
        """The (padded) batch's program over dp x fp devices. One device:
        the bucket's program in ``chunk``-wide steps. Otherwise the batch
        splits into dp contiguous sub-batches, each run on its grid row
        by that device's program (tiled over the row when fp > 1) under
        the same chunk schedule, and the outputs are gathered onto the
        detector's device (repro/core/detector.py:654, :983); nothing is
        read back to the host."""
        if dp == 1 and fp == 1:
            return _batch_fn(prog.fn, h, w, ph, pw, batch, chunk)
        local = batch // dp
        rows = [(devs[0], _batch_fn(
            self._tiled_step(ph, pw, fp, devs) if fp > 1
            else self._program_on(ph, pw, devs[0]).fn,
            h, w, ph, pw, local, chunk)) for devs in self._grid(dp, fp)]
        home = self.device

        def fn(frames: Tensor, wv: Tensor, bv: Tensor, hws):
            outs = [run(frames[r * local:(r + 1) * local].to(dev),
                        wv.to(dev), bv.to(dev),
                        hws[r * local:(r + 1) * local])
                    for r, (dev, run) in enumerate(rows)]
            return tuple(torch.cat([o[j].to(home) for o in outs])
                         for j in range(4))

        return fn

    def _to_gray(self, image) -> Tensor:
        """One frame -> f32 gray on the device, the EAGER luma, as the
        reference's host-side prep of mixed-size batches
        (repro/core/detector.py:1189)."""
        _frame_hw(tuple(image.shape))
        frame = torch.as_tensor(image).to(self.device)
        return (grayscale(frame) if frame.dim() == 3
                else frame).to(torch.float32)

    @staticmethod
    def _pad_to(gray: Tensor, ph: int, pw: int) -> Tensor:
        h, w = gray.shape
        if (ph, pw) == (h, w):
            return gray
        return F.pad(gray[None, None], (0, pw - w, 0, ph - h),
                     mode="replicate")[0, 0]

    def detect_raw(self, image) -> "Detections":
        """One frame (numpy or tensor, (H, W) gray or (H, W, 3) RGB) ->
        Detections whose tensors stay on the device until decoded: the
        bucket's program on a batch of one."""
        from ..api.results import Detections
        h, w = _frame_hw(tuple(image.shape))
        frame = torch.as_tensor(image).to(self.device)
        prog, ph, pw = self.program_for(h, w)
        if prog.fn is None:
            return Detections.empty(prog.tables, self.classes)
        fp = self._tiled_for(ph, pw)
        step = prog.fn if fp == 1 else \
            self._tiled_step(ph, pw, fp, self._grid(1, fp)[0])
        out = step(_prep_frame(frame, h, w, ph, pw)[None], self.svm["w"],
                   self.svm["b"], ((h, w),))
        top, idx, keep, n_valid = (t[0].to(self.device) for t in out)
        return Detections(top, idx, keep, n_valid, prog.tables,
                          classes=self.classes)

    def __call__(self, image) -> List[dict]:
        """Legacy per-frame contract (list of dicts)."""
        return self.detect_raw(image).to_list()

    def _stack(self, frames) -> Tensor:
        if isinstance(frames, (list, tuple)):
            if any(isinstance(f, torch.Tensor) for f in frames):
                return torch.stack([torch.as_tensor(f).to(self.device)
                                    for f in frames])
            return torch.from_numpy(np.stack([np.asarray(f)
                                              for f in frames])
                                    ).to(self.device)
        return torch.as_tensor(frames).to(self.device)

    def detect_batch_raw(self, frames) -> "Detections":
        """Batched frame path: B frames -> one batched Detections.

        ``frames`` is a stacked (B, H, W[, 3]) array or tensor, or a
        sequence of frames. All frames must land in the SAME padded shape
        bucket; mixed buckets raise ValueError. Frames of one shape take
        the program's in-program prep (the jitted reference's fused luma);
        frames of mixed true sizes are turned gray (the eager luma) and
        edge-padded first, each keeping its own true size in the inside
        mask. The batch runs in ``batch_chunk``-wide steps (0: measured
        at first use, ``_autotune_chunk``); top-k and NMS run on the
        device and nothing is read back until the result is decoded.
        """
        from ..api.results import Detections
        if isinstance(frames, (list, tuple)) and not frames:
            return Detections.empty_batch(_empty_tables(), 0, self.classes)
        uniform = not isinstance(frames, (list, tuple)) or \
            len({tuple(f.shape) for f in frames}) == 1
        if uniform:
            shape = tuple(frames.shape) if not isinstance(
                frames, (list, tuple)) else (len(frames),) + tuple(
                frames[0].shape)
            if not isinstance(frames, (list, tuple)) \
                    and len(shape) == 3 and shape[-1] == 3:
                # a bare (H, W, 3) RGB frame would silently parse as H
                # gray frames of width 3 -- an ambiguity no caller wants
                raise ValueError(
                    f"shape {shape} looks like a single RGB frame; pass "
                    f"a list of frames or a stacked (B, H, W[, 3]) array")
            if not (len(shape) == 3
                    or (len(shape) == 4 and shape[-1] == 3)):
                raise ValueError(
                    f"expected (B, H, W[, 3]) stacked frames, got shape "
                    f"{shape}")
            n, h, w = shape[:3]
            if n == 0:
                return Detections.empty_batch(_empty_tables(), 0,
                                              self.classes)
            hws = ((h, w),) * n
        else:
            grays = [self._to_gray(f) for f in frames]
            n = len(grays)
            hws = tuple((int(g.shape[0]), int(g.shape[1])) for g in grays)
        buckets = {self.program_for(h, w)[1:] for h, w in hws}
        if len(buckets) != 1:
            raise ValueError(
                f"detect_batch needs one shape bucket per call, got "
                f"{sorted(buckets)}; group frames by bucket first")
        prog, ph, pw = self.program_for(*hws[0])
        if prog.fn is None:
            return Detections.empty_batch(prog.tables, n, self.classes)
        if uniform:
            th, tw = hws[0]
            frames_b = self._stack(frames)
        else:
            th, tw = ph, pw
            frames_b = torch.stack([self._pad_to(g, ph, pw) for g in grays])
        dp = self._resolve_dp()
        n_pad = _round_up(n, dp)
        if n_pad != n:
            # pad up to the data axis with zero frames whose true size is
            # (0, 0): every window fails the inside test, and the pad
            # rows are sliced off below
            frames_b = torch.cat([frames_b, frames_b.new_zeros(
                (n_pad - n,) + tuple(frames_b.shape[1:]))])
            hws = tuple(hws) + ((0, 0),) * (n_pad - n)
        fp = self._tiled_for(ph, pw, dp)

        def build(chunk: int) -> Callable:
            return self._batch_program(prog, th, tw, ph, pw, n_pad, dp, fp,
                                       chunk)

        chunk = self.cfg.batch_chunk
        if chunk == 0:
            chunk = _autotune_chunk(build, th, tw, ph, pw, n_pad, self.cfg,
                                    tuple(frames_b.shape), frames_b.dtype,
                                    self.device, self.heads, dp, fp)
        top, idx, keep, n_valid = (t[:n] for t in build(chunk)(
            frames_b, self.svm["w"], self.svm["b"], hws))
        return Detections(top, idx, keep, n_valid, prog.tables,
                          classes=self.classes)

    def detect_batch(self, frames) -> List[List[dict]]:
        """Legacy batched contract (B per-frame dict lists)."""
        return self.detect_batch_raw(frames).to_list()


def detect(image_rgb, svm, cfg: Optional[DetectorConfig] = None,
           device=None) -> List[dict]:
    """Multi-scale detection: [{box: (y0, x0, y1, x1), score, scale}] in
    descending score order."""
    return FrameDetector(svm, cfg, device)(image_rgb)
