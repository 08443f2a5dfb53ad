"""Multi-scale sliding-window human detector, single-frame path -- the
port of repro/core/detector.py.

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

What the port does not run yet raises NotImplementedError naming the
later slice: stacked multi-head weights, the banded resize, data/frame
parallelism and the batched path.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import svm_matmul as sm
from . import numerics as N
from . import quant
from .hog import HOGConfig, PAPER_HOG, grayscale_fused
from .stages import BACKENDS, dense_blocks

Tensor = torch.Tensor

MULTI_HEAD_LATER = ("stacked multi-head SVM weights (2-D w): a later slice "
                    "of the port (multi-head)")
BATCH_LATER = "detect_batch (the batched path): a later slice of the port"


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Same fields and defaults as repro/core/detector.py:100, so a
    reference configuration loads unchanged. Fields this slice does not
    run are rejected by ``FrameDetector`` with NotImplementedError."""

    hog: HOGConfig = PAPER_HOG
    scales: Tuple[float, ...] = (1.0, 0.8, 0.64)
    score_threshold: float = 0.0          # sign(D(x)) per eq. (7)
    nms_iou: float = 0.3
    max_detections: int = 0               # top-k size K; 0 = auto
    backend: str = "ref"                  # "ref" | "kernel" | "fused"
    shape_bucket: int = 32                # frames pad up to multiples
    batch_chunk: int = 0                  # batched path (later slice)
    data_parallel: int = 1                # multi-device (later slice)
    frame_parallel: int = 1               # intra-frame tiling (later)
    tile_mode: str = "slab"               # intra-frame tiling (later)
    frame_parallel_min_area: int = 0      # intra-frame tiling (later)
    pyramid_resize: str = "matmul"        # "matmul"; "banded" later
    class_thresholds: Tuple[float, ...] = ()  # multi-head (later slice)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Without a GPU, anything but an explicit CPU request raises;
    there is no silent fallback. On the card, TF32 is switched off for
    cuBLAS and cuDNN so the resize matmuls stay full f32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def check_supported(cfg: DetectorConfig) -> None:
    """Raise NotImplementedError for every setting the port accepts in a
    configuration but does not run yet, and ValueError for invalid ones."""
    if cfg.pyramid_resize == "banded":
        raise NotImplementedError(
            "pyramid_resize='banded' (core/tiling.py:resize_banded): a later "
            "slice of the port (multi-device and tiling)")
    if cfg.pyramid_resize != "matmul":
        raise ValueError(
            f"DetectorConfig.pyramid_resize={cfg.pyramid_resize!r}: "
            f"expected 'matmul' or 'banded'")
    if cfg.data_parallel != 1:
        raise NotImplementedError(
            f"data_parallel={cfg.data_parallel}: multi-device sharding is a "
            f"later slice of the port")
    if cfg.frame_parallel != 1:
        raise NotImplementedError(
            f"frame_parallel={cfg.frame_parallel}: intra-frame tiling is a "
            f"later slice of the port")
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown stage backend {cfg.backend!r}; "
                         f"expected one of {sorted(BACKENDS)}")


def scene_blocks(gray: Tensor, cfg: HOGConfig, backend: str = "ref") -> Tensor:
    """Whole-scene normalized block grid: (H, W) -> (BH, BW, 36)."""
    return dense_blocks(gray, cfg, backend)


def score_blocks(blocks: Tensor, w: Tensor, b: Tensor,
                 cfg: HOGConfig = PAPER_HOG,
                 use_kernel: bool = False) -> Tensor:
    """Score the dense block grid: (BH, BW, 36) -> (PH, PW).

    score[i, j] = <blocks[i:i+15, j:j+7, :], W> + b, factored as ONE
    (BH*BW, 36) @ (36, 105) matmul of per-offset partial scores (the
    score_matmul kernel when ``use_kernel``) and 105 shifted adds in the
    reference's order: from zeros, offsets (di, dj) row-major, then b.
    bf16 blocks meet bf16 weights, accumulated in f32.

    Fixed numerics (repro/core/detector.py:205-224): the block grid is
    already on its per-block int8 grid, so requantizing recovers the
    codes exactly; the weights quantize per offset column; the int8
    product (the score_matmul_int8 kernel when ``use_kernel``) is exact
    int32, and the rank-1 rescale has a fixed multiply order.
    """
    if w.dim() == 2:
        raise NotImplementedError(MULTI_HEAD_LATER)
    bh, bw = cfg.blocks_hw                              # 15, 7
    BH, BW, bd = blocks.shape
    flat = blocks.reshape(BH * BW, bd).contiguous()
    if N.spec_for(cfg).quantized:
        q, s_rows = quant.quantize_blocks(flat)
        wt = w.reshape(bh * bw, bd).T.to(torch.float32)
        wq, s_cols = quant.quantize_weight_columns(wt)
        wq = wq.contiguous()
        ci = (sm.score_matmul_int8(q, wq) if use_kernel
              else sm.score_matmul_int8_plain(q, wq))
        contrib = quant.rescale_scores(ci, s_rows, s_cols)
    else:
        wt = w.reshape(bh * bw, bd).T.to(blocks.dtype).contiguous()
        contrib = (sm.score_matmul(flat, wt) if use_kernel
                   else sm.score_matmul_plain(flat, wt))
    return collate_scores(contrib.reshape(BH, BW, bh * bw), bh, bw) + b


def collate_scores(contrib: Tensor, bh: int, bw: int) -> Tensor:
    """Sum the per-offset partial scores into the window score map:
    (BH, BW, bh*bw) -> (BH-bh+1, BW-bw+1), from zeros, offsets (di, dj)
    row-major, as the reference accumulates them (bias not added)."""
    ph, pw = contrib.shape[0] - bh + 1, contrib.shape[1] - bw + 1
    out = torch.zeros((ph, pw), dtype=torch.float32, device=contrib.device)
    for di in range(bh):
        for dj in range(bw):
            out = out + contrib[di:di + ph, dj:dj + pw, di * bw + dj]
    return out


def score_map(gray: Tensor, w: Tensor, b: Tensor, cfg: HOGConfig = PAPER_HOG,
              backend: str = "ref") -> Tensor:
    """Dense SVM score map at cell (8-px) stride. gray: (H, W) -> (PH, PW)."""
    blocks = scene_blocks(gray, cfg, backend)
    return score_blocks(blocks, w, b, cfg, use_kernel=(backend != "ref"))


# ------------------------------------------------------------------- NMS

def matrix_iou(a: Tensor, b: Tensor) -> Tensor:
    """Pairwise IoU. a: (N, 4), b: (M, 4) as (y0, x0, y1, x1) -> (N, M)."""
    y0 = torch.maximum(a[:, None, 0], b[None, :, 0])
    x0 = torch.maximum(a[:, None, 1], b[None, :, 1])
    y1 = torch.minimum(a[:, None, 2], b[None, :, 2])
    x1 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(y1 - y0, min=0.0) * torch.clamp(x1 - x0, min=0.0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter,
                               min=1e-9)


def nms_keep(boxes: Tensor, scores: Tensor, iou_thr: float) -> Tensor:
    """Greedy NMS on the device over boxes sorted by descending score;
    entries with score -inf are invalid and never kept.

    The reference runs a fori_loop over K whose step i keeps box i iff it
    is valid and no kept box j < i overlaps it by more than ``iou_thr``.
    The loop-invariant part of that test, (iou > thr) & (j < i), is built
    once here; the sequential dependency stays a K-step loop of small
    tensor ops (an NMS kernel is later work).
    """
    k = boxes.shape[0]
    iou = matrix_iou(boxes, boxes)
    valid = torch.isfinite(scores)
    rank = torch.arange(k, device=boxes.device)
    sup = (iou > iou_thr) & (rank[:, None] < rank[None, :])
    keep = torch.zeros((k,), dtype=torch.bool, device=boxes.device)
    for i in range(k):
        keep[i] = valid[i] & ~torch.any(keep & sup[:, i])
    return keep


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
    """The k largest values and their indices, ties to the lower index
    (lax.top_k's order, which torch.topk does not promise)."""
    srt = torch.sort(x, descending=True, stable=True)
    return srt.values[:k], srt.indices[:k]


# ---------------------------------------------- per-bucket frame program

def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b if b > 1 else a


def _resolve_k(cfg: DetectorConfig, n: int) -> int:
    """Top-k size for n window positions: max_detections when set, else
    K = max(256, ceil(n / 256)) clamped to n."""
    if cfg.max_detections:
        return min(cfg.max_detections, n)
    return min(n, max(256, -(-n // 256)))


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

    The column sums follow XLA:CPU's reduction: rows in chunks of 32,
    each chunk summed in index order, then the chunk sums in order. For
    a ``src`` that is a multiple of 32 (every frame bucket, as
    ``shape_bucket`` is 32) that reproduces the reference bit for bit;
    other sizes tried (40, 97, 150, 331, 577, 1080, 2160) leave a few
    entries one ulp off, which tests/test_torch_detector.py holds within
    1.2e-7.
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
    total = np.zeros((1, dst), np.float32)
    for c0 in range(0, src, 32):
        chunk = np.zeros((1, dst), np.float32)
        for i in range(c0, min(c0 + 32, src)):
            chunk = chunk + w[i:i + 1]
        total = total + chunk
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

    fn: Optional[Callable]         # (gray_pad, w, b, (h, w)) ->
    #                                (top, idx, keep, n_valid)
    boxes: np.ndarray              # (N, 4) window boxes in frame coords
    scales: np.ndarray             # (N,) nominal pyramid scale per row
    n_positions: int               # N: window positions, all scales
    k: int                         # top-k size
    per_scale: Tuple[Tuple[float, int, int], ...] = ()
    #                (scale, score-map PH, score-map PW) per pyramid level
    tables: Optional[DecodeTables] = None
    pyramid: Optional[Callable] = None  # gray_pad -> one gray per level


def _frame_program(ph: int, pw: int, cfg: DetectorConfig,
                   device: torch.device) -> FrameProgram:
    """Build the program for padded frame shape (ph, pw) on ``device``:
    per-scale pyramid shapes, the flattened box table, the resize weights
    and K are fixed here; the returned ``fn`` runs one frame."""
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
    # torch.tensor copies: the cached tables are shared by every program
    resize_w = {(sh, sw): (
        torch.tensor(_resize_weights(ph, sh), device=device),
        torch.tensor(_resize_weights(pw, sw), device=device))
        for sh, sw, _ in specs if (sh, sw) != (ph, pw)}
    inside_masks: Dict[Tuple[int, int], Tensor] = {}

    def inside_mask(h: int, w: int) -> Tensor:
        # windows must lie inside the TRUE frame; the reference adds 1e-4
        # to the f32 frame size in f32, and so does this host-side mask
        m = inside_masks.get((h, w))
        if m is None:
            lim_h = np.float32(h) + np.float32(1e-4)
            lim_w = np.float32(w) + np.float32(1e-4)
            m = torch.from_numpy((boxes_tab[:, 2] <= lim_h)
                                 & (boxes_tab[:, 3] <= lim_w)).to(device)
            inside_masks[(h, w)] = m
        return m

    def pyramid(gray: Tensor) -> List[Tensor]:
        levels = []
        for sh, sw, _ in specs:
            if (sh, sw) == (ph, pw):
                levels.append(gray)
            else:
                wy, wx = resize_w[(sh, sw)]
                levels.append((wy @ gray) @ wx.T)
        return levels

    def fn(gray: Tensor, w: Tensor, b: Tensor, hw: Tuple[int, int]):
        parts = [score_map(g, w, b, hcfg, cfg.backend).reshape(-1)
                 for g in pyramid(gray)]
        scores = parts[0] if len(parts) == 1 else torch.cat(parts)
        valid = inside_mask(*hw) & (scores > cfg.score_threshold)
        masked = torch.where(valid, scores, float("-inf"))
        top, idx = top_k(masked, k)
        keep = nms_keep(boxes_dev[idx], top, cfg.nms_iou)
        return top, idx, keep, torch.sum(valid)

    return FrameProgram(fn, boxes_tab, scale_tab, n, k, tuple(per_scale),
                        tables=DecodeTables(boxes_tab, scale_tab, k),
                        pyramid=pyramid)


def _prep_frame(frame: Tensor, h: int, w: int, ph: int, pw: int) -> Tensor:
    """Grayscale (RGB input only) and edge-pad the frame to its bucket.
    The gray is the reference's jitted luma (``grayscale_fused``: its two
    fused multiply-adds, exact for uint8 frames), on the frame's device.
    Replicate padding keeps downscaling from bleeding zeros into the last
    valid windows near the pad seam."""
    g = (grayscale_fused(frame) if frame.dim() == 3
         else frame.to(torch.float32))
    if (ph, pw) != (h, w):
        # F.pad's replicate mode wants leading batch and channel dims
        g = F.pad(g[None, None], (0, pw - w, 0, ph - h),
                  mode="replicate")[0, 0]
    return g


def as_svm(svm, device: torch.device,
           n_features: int = PAPER_HOG.n_features) -> Dict[str, Tensor]:
    """{"w": (F,), "b": ()} numpy arrays or tensors -> f32 tensors on
    ``device``; stacked (2-D) heads are a later slice."""
    w = torch.as_tensor(svm["w"], dtype=torch.float32).to(device)
    b = torch.as_tensor(svm["b"], dtype=torch.float32).to(device)
    if w.dim() == 2:
        raise NotImplementedError(MULTI_HEAD_LATER)
    if tuple(w.shape) != (n_features,) or b.numel() != 1:
        raise ValueError(f"expected w ({n_features},) and b (), got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    return {"w": w, "b": b.reshape(())}


class FrameDetector:
    """Reusable handle: SVM params + config -> per-frame detections.

    Builds one program per frame-shape bucket on first use; only the
    final box decode touches host numpy. Runs on CUDA unless
    ``device="cpu"``; raises RuntimeError when no GPU is present and the
    CPU was not asked for.
    """

    def __init__(self, svm, cfg: Optional[DetectorConfig] = None,
                 device=None):
        self.cfg = DetectorConfig() if cfg is None else cfg
        check_supported(self.cfg)
        self.device = resolve_device(device)
        self.svm = as_svm(svm, self.device, self.cfg.hog.n_features)
        self._programs: Dict[Tuple[int, int], FrameProgram] = {}

    def program_for(self, h: int, w: int) -> Tuple[FrameProgram, int, int]:
        b = max(1, self.cfg.shape_bucket)
        ph, pw = _round_up(h, b), _round_up(w, b)
        prog = self._programs.get((ph, pw))
        if prog is None:
            prog = _frame_program(ph, pw, self.cfg, self.device)
            self._programs[(ph, pw)] = prog
        return prog, ph, pw

    def bucket_for(self, frame) -> Tuple[int, int]:
        """Padded-bucket shape a frame would run under; raises ValueError
        on malformed shapes."""
        h, w = _frame_hw(tuple(frame.shape))
        _, ph, pw = self.program_for(h, w)
        return ph, pw

    def detect_raw(self, image) -> "Detections":
        """One frame (numpy or tensor, (H, W) gray or (H, W, 3) RGB) ->
        Detections whose tensors stay on the device until decoded."""
        from ..api.results import Detections
        h, w = _frame_hw(tuple(image.shape))
        frame = torch.as_tensor(image).to(self.device)
        prog, ph, pw = self.program_for(h, w)
        if prog.fn is None:
            return Detections.empty(prog.tables)
        top, idx, keep, n_valid = prog.fn(_prep_frame(frame, h, w, ph, pw),
                                          self.svm["w"], self.svm["b"],
                                          (h, w))
        return Detections(top, idx, keep, n_valid, prog.tables)

    def __call__(self, image) -> List[dict]:
        """Legacy per-frame contract (list of dicts)."""
        return self.detect_raw(image).to_list()

    def detect_batch(self, frames):
        raise NotImplementedError(BATCH_LATER)


def detect(image_rgb, svm, cfg: Optional[DetectorConfig] = None,
           device=None) -> List[dict]:
    """Multi-scale detection: [{box: (y0, x0, y1, x1), score, scale}] in
    descending score order."""
    return FrameDetector(svm, cfg, device)(image_rgb)
