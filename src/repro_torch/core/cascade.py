"""Two-stage cascade: cheap coarse reject, full HOG+SVM on survivors --
the port of repro/core/cascade.py.

The dense path scores every window of every pyramid scale; on sparse
scenes nearly all of that work scores empty background. The cascade runs
a CHEAP first stage over the whole frame -- a half-resolution coarse head
(66x34 window, 7x3 blocks, 756 features against 3780) swept over a
reduced scale set -- and promotes only the neighbourhoods of its
loose-threshold hits to the full pipeline, which then runs dense on a
few snapped crops instead of the whole frame. Both stages are the SAME
dense program family (core/detector.py) with another HOG geometry: on
the card the same dense kernels, the coarse head's scorer a (M, 36) @
(36, 21) product. The cascade itself is a host-side scheduler.

Stage layout per frame:

    coarse FrameDetector (66x34 head, coarse_scales, LOOSE threshold)
        -> candidate boxes
    + tracker-predicted ROI boxes (video)
        -> plan_regions(): dilate, merge overlapping neighbourhoods,
           cap at max_regions, snap OUTWARD to the snap grid
        -> fine FrameDetector on each cropped region (full window,
           full scales), boxes offset back to frame coordinates
        -> one host NMS per class across regions (crops can overlap)

Monotonicity: loosening the coarse threshold only ADDS candidate boxes,
and ``plan_regions`` covers every candidate's dilated box by some region
(bounding rects only grow under merging, edges only snap outward), so a
looser reject threshold never loses a survivor. Tracker ROIs enter the
planner beside the coarse hits, so a tracked pedestrian the coarse stage
misses still has its neighbourhood scored by the fine stage.

The coarse head trains as the reference's (``train_coarse_head``), with
one recorded difference: the training windows are resized to 66x34 on
the weights of ``core/detector.py:_resize_weights`` summed in f64 and
rounded once to f32 (as the frame pyramid and mining's crops are), where
the reference's ``jax.image.resize`` sums in f32 in its own order.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .detector import DetectorConfig, FrameDetector, _nms, _resize_weights
from .hog import HOGConfig

# coarse head geometry: the paper's 130x66 pedestrian window at half
# resolution (active 64x32 -> 7x3 blocks -> 756 features); scales chosen
# so the coarse sweep covers the person heights of the fine sweep's
# (1.0, 0.8, 0.64)
COARSE_WINDOW = (66, 34)
_COARSE_NAME = "_coarse"                    # registry name (auxiliary)
#: training windows resized a chunk at a time (f64 on the device)
_RESIZE_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Knobs of the two-stage scheduler, the reference's fields and
    defaults (repro/core/cascade.py:60)."""

    enabled: bool = False          # session opt-in
    coarse_scales: Tuple[float, ...] = (0.5, 0.4, 0.32)
    #   sweep scales of the 66x34 coarse head; 0.5 matches fine scale
    #   1.0 (both see a 132px person), 0.32 matches 0.64
    coarse_threshold: float = 0.0  # LOOSE coarse score gate, well below
    #   the fine threshold so borderline pedestrians reach the fine stage
    coarse_max_detections: int = 64
    margin: int = 24               # px each candidate box dilates by
    snap: int = 36                 # region edges snap OUTWARD to this
    #   grid (a multiple of the 6-px cell stride keeps a crop's window
    #   grid on the frame's), so region shapes fall in few buckets
    max_regions: int = 4           # neighbourhoods merge down to this
    min_frame_area: int = 0        # smaller frames run the fine stage dense
    fine_hysteresis: float = 0.0   # crops run at (score_threshold - this):
    #   a crop's HOG grid is offset against the full frame's, so window
    #   scores jitter; 0 = crops run at the exact fine threshold


# --------------------------------------------------------------- planner

def _snap_regions(rects: Sequence[Tuple[float, float, float, float]],
                  frame_hw: Tuple[int, int], snap: int
                  ) -> List[Tuple[int, int, int, int]]:
    h, w = frame_hw
    out = []
    for y0, x0, y1, x1 in rects:
        y0 = max(0, int(np.floor(y0 / snap)) * snap)
        x0 = max(0, int(np.floor(x0 / snap)) * snap)
        y1 = min(h, int(np.ceil(y1 / snap)) * snap)
        x1 = min(w, int(np.ceil(x1 / snap)) * snap)
        if y1 > y0 and x1 > x0:
            out.append((y0, x0, y1, x1))
    return out


def plan_regions(boxes, frame_hw: Tuple[int, int],
                 cfg: Optional[CascadeConfig] = None
                 ) -> List[Tuple[int, int, int, int]]:
    """Candidate boxes -> at most ``max_regions`` fine-stage crops.

    ``boxes`` is (N, 4) of (y0, x0, y1, x1) in frame coordinates (coarse
    hits and promoted track predictions). Every box dilates by
    ``margin``, overlapping dilated boxes merge into one neighbourhood
    (connected components of the overlap graph), components merge
    further -- closest pair first -- until at most ``max_regions``
    remain, and each component's bounding rect snaps OUTWARD to the
    ``snap`` grid. Every input box's dilated rect lies inside one
    returned region."""
    cfg = cfg or CascadeConfig()
    h, w = int(frame_hw[0]), int(frame_hw[1])
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    if len(boxes) == 0:
        return []
    m = float(cfg.margin)
    rects = np.stack([
        np.clip(boxes[:, 0] - m, 0, h), np.clip(boxes[:, 1] - m, 0, w),
        np.clip(boxes[:, 2] + m, 0, h), np.clip(boxes[:, 3] + m, 0, w),
    ], axis=1)
    # connected components of the pairwise-overlap graph (union-find)
    n = len(rects)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    overlap = ((rects[:, None, 0] < rects[None, :, 2])
               & (rects[None, :, 0] < rects[:, None, 2])
               & (rects[:, None, 1] < rects[None, :, 3])
               & (rects[None, :, 1] < rects[:, None, 3]))
    for i in range(n):
        for j in range(i + 1, n):
            if overlap[i, j]:
                parent[find(i)] = find(j)
    comps: Dict[int, List[int]] = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    bounds = [(float(rects[ix, 0].min()), float(rects[ix, 1].min()),
               float(rects[ix, 2].max()), float(rects[ix, 3].max()))
              for ix in (np.asarray(c) for c in comps.values())]
    # cap at max_regions: repeatedly merge the closest pair (rect gap)
    while len(bounds) > max(1, cfg.max_regions):
        best, bi, bj = None, 0, 1
        for i in range(len(bounds)):
            for j in range(i + 1, len(bounds)):
                a, b = bounds[i], bounds[j]
                dy = max(0.0, max(a[0], b[0]) - min(a[2], b[2]))
                dx = max(0.0, max(a[1], b[1]) - min(a[3], b[3]))
                gap = dy * dy + dx * dx
                if best is None or gap < best:
                    best, bi, bj = gap, i, j
        a, b = bounds[bi], bounds[bj]
        merged = (min(a[0], b[0]), min(a[1], b[1]),
                  max(a[2], b[2]), max(a[3], b[3]))
        bounds = [r for k, r in enumerate(bounds) if k not in (bi, bj)]
        bounds.append(merged)
    return sorted(_snap_regions(bounds, (h, w), max(1, cfg.snap)))


# ----------------------------------------------------- degraded entry points

def reduced_detector(det: FrameDetector, n_scales: int = 1
                     ) -> FrameDetector:
    """Degradation-ladder rung "reduced" (serve/resilience.py): the SAME
    head and numerics on a truncated pyramid -- only the first
    `n_scales` scales are swept, so far-away (small) pedestrians are
    the quality traded for latency under overload. Shares the svm
    params, class labels and device, so recovered full-pipeline results
    are byte-identical to an undegraded run."""
    cfg = dataclasses.replace(det.cfg,
                              scales=det.cfg.scales[:max(1, int(n_scales))])
    return FrameDetector(det.svm, cfg, device=det.device, classes=det.classes)


# ------------------------------------------------------------ coarse head

def coarse_hog(fine: HOGConfig) -> HOGConfig:
    """The coarse stage's HOG geometry: the fine config's numerics on the
    half-resolution window."""
    return dataclasses.replace(fine, window_h=COARSE_WINDOW[0],
                               window_w=COARSE_WINDOW[1])


def resize_windows(x: np.ndarray, wh: int, ww: int,
                   device: torch.device) -> torch.Tensor:
    """(N, H, W, 3) uint8 windows -> (N, wh, ww, 3) f32 on ``device``:
    jax.image.resize's "linear" weights (``_resize_weights``) on each
    axis, summed in f64 and rounded once to f32."""
    n, h, w = x.shape[:3]
    wy = torch.from_numpy(_resize_weights(h, wh).astype(np.float64)).to(device)
    wx = torch.from_numpy(_resize_weights(w, ww).astype(np.float64)).to(device)
    out = []
    for i in range(0, n, _RESIZE_CHUNK):
        c = torch.from_numpy(np.ascontiguousarray(x[i:i + _RESIZE_CHUNK])
                             ).to(device, torch.float64)
        c = torch.einsum("ih,nhwc->niwc", wy, c)
        c = torch.einsum("jw,niwc->nijc", wx, c)
        out.append(c.to(torch.float32))
    return torch.cat(out)


def train_coarse_head(fine_hog: HOGConfig, train_cfg=None,
                      n_pos: int = 1500, n_neg: int = 1000,
                      rng: Optional[np.random.Generator] = None,
                      hard_negative_rounds: int = 1,
                      mine_scenes: int = 12, device=None,
                      record: Optional[dict] = None
                      ) -> Tuple[Dict[str, torch.Tensor], HOGConfig]:
    """Train the cascade's coarse SVM on ``device`` (CUDA unless the CPU
    is asked for): synthetic pedestrian windows resized to the 66x34
    coarse geometry (``resize_windows``), their descriptors on the plain
    stages, Pegasos (core/svm.py), then ``hard_negative_rounds`` of
    scene-level bootstrapping (data/mining.py) so the LOOSE reject gate
    stays quiet on empty frames. The reference's schedule and draws
    (repro/core/cascade.py:206). Returns (params, coarse HOGConfig).

    ``record``, a dict, receives what another device needs to repeat the
    run step by step: the first head ("first"), each round's rng state
    before its sweep and its mined crops ("rounds": [(state, crops)]),
    and the final features and labels ("feats", "labels")."""
    from ..data.mining import mine_hard_negatives
    from ..data.synth_pedestrian import PedestrianDataConfig, make_windows
    from .detector import resolve_device
    from .hog import hog_descriptor
    from .svm import SVMTrainConfig, train_svm
    dev = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    x, y = make_windows(n_pos, n_neg, PedestrianDataConfig(), rng)
    ch = coarse_hog(fine_hog)
    feats = hog_descriptor(resize_windows(x, ch.window_h, ch.window_w, dev),
                           ch)
    labels = torch.from_numpy(np.asarray(y)).to(dev)
    tc = train_cfg or SVMTrainConfig()
    svm, _ = train_svm(feats, labels, tc)
    rec = {} if record is None else record
    rec.update(first=svm, rounds=[])
    sweep = DetectorConfig(hog=ch, scales=CascadeConfig().coarse_scales)
    for _ in range(int(hard_negative_rounds)):
        state = copy.deepcopy(rng.bit_generator.state)
        neg = mine_hard_negatives(svm, sweep, mine_scenes, rng, device=dev)
        rec["rounds"].append((state, neg))
        if not len(neg):
            break
        feats = torch.cat([feats, hog_descriptor(
            torch.from_numpy(neg).to(dev, torch.float32), ch)])
        labels = torch.cat([labels, labels.new_zeros(len(neg))])
        svm, _ = train_svm(feats, labels, tc)
    rec.update(feats=feats, labels=labels)
    return svm, ch


def coarse_detector(coarse_svm, fine_cfg: DetectorConfig,
                    cascade: CascadeConfig, device=None) -> FrameDetector:
    """The stage-1 detector: coarse head geometry, the cascade's reduced
    scale sweep and LOOSE threshold, the fine stage's backend and
    numerics, on ``device`` (CUDA unless the CPU is asked for)."""
    ccfg = dataclasses.replace(
        fine_cfg, hog=coarse_hog(fine_cfg.hog),
        scales=cascade.coarse_scales,
        score_threshold=cascade.coarse_threshold,
        max_detections=cascade.coarse_max_detections,
        class_thresholds=(), frame_parallel=1)
    return FrameDetector(coarse_svm, ccfg, device)


# --------------------------------------------------------------- cascade

class CascadeDetector:
    """Two-stage scheduler over a coarse and a fine FrameDetector.

    ``detect(frame, roi_boxes=...)`` returns the fine detector's
    list-of-dicts contract (multi-class dicts keep class_id / label),
    and ``stats`` accumulates: frames, frames_empty (the coarse stage
    rejected everything), frames_dense (below min_frame_area: a full
    pass), regions, region_area_frac (fine-stage pixel fraction against
    dense, summed over frames).
    """

    def __init__(self, fine: FrameDetector, coarse: FrameDetector,
                 cfg: Optional[CascadeConfig] = None):
        self.fine = fine
        self.coarse = coarse
        self.cfg = cfg or CascadeConfig()
        hyst = float(self.cfg.fine_hysteresis)
        if hyst > 0:
            fc = fine.cfg
            self._crop_fine = FrameDetector(fine.svm, dataclasses.replace(
                fc, score_threshold=fc.score_threshold - hyst,
                class_thresholds=tuple(t - hyst
                                       for t in fc.class_thresholds)),
                device=fine.device, classes=fine.classes)
        else:
            self._crop_fine = fine
        self.stats: Dict[str, float] = {
            "frames": 0, "frames_empty": 0, "frames_dense": 0,
            "regions": 0, "region_area_frac": 0.0}

    def _merge(self, dets: List[dict]) -> List[dict]:
        """One host NMS pass per class across region-local results
        (regions may overlap after snapping)."""
        out: List[dict] = []
        by_class: Dict[object, List[dict]] = {}
        for d in dets:
            by_class.setdefault(d.get("class_id"), []).append(d)
        for ds in by_class.values():
            ds.sort(key=lambda d: -d["score"])
            boxes = np.asarray([d["box"] for d in ds],
                               np.float32).reshape(-1, 4)
            scores = np.asarray([d["score"] for d in ds], np.float32)
            out.extend(ds[i] for i in
                       _nms(boxes, scores, self.fine.cfg.nms_iou))
        out.sort(key=lambda d: -d["score"])
        return out

    @staticmethod
    def _frame(frame):
        return frame if isinstance(frame, torch.Tensor) else np.asarray(frame)

    def detect(self, frame, roi_boxes: Sequence = ()) -> List[dict]:
        """One frame (numpy or tensor) -> detection dicts. ``roi_boxes``
        are promoted regions (tracker-predicted boxes) that bypass the
        coarse gate."""
        frame = self._frame(frame)
        h, w = int(frame.shape[0]), int(frame.shape[1])
        self.stats["frames"] += 1
        if h * w < self.cfg.min_frame_area:
            self.stats["frames_dense"] += 1
            self.stats["region_area_frac"] += 1.0
            return self.fine.detect_raw(frame).to_list()
        cand = [d["box"] for d in self.coarse.detect_raw(frame).to_list()]
        cand += [tuple(float(v) for v in b) for b in roi_boxes]
        if not cand:
            self.stats["frames_empty"] += 1
            return []
        regions = plan_regions(np.asarray(cand, np.float32), (h, w),
                               self.cfg)
        self.stats["regions"] += len(regions)
        area = sum((y1 - y0) * (x1 - x0) for y0, x0, y1, x1 in regions)
        self.stats["region_area_frac"] += min(1.0, area / float(h * w))
        dets: List[dict] = []
        for y0, x0, y1, x1 in regions:
            # crops run through the hysteresis-banded detector (the fine
            # detector itself when cfg.fine_hysteresis == 0)
            for d in self._crop_fine.detect_raw(
                    frame[y0:y1, x0:x1]).to_list():
                by0, bx0, by1, bx1 = d["box"]
                d = dict(d)
                d["box"] = (by0 + y0, bx0 + x0, by1 + y0, bx1 + x0)
                dets.append(d)
        return self._merge(dets)

    def detect_degraded(self, frame, mode: str = "cascade",
                        roi_boxes: Sequence = ()) -> List[dict]:
        """Degraded entry point of the serving ladder: "cascade" runs the
        two-stage schedule, "coarse" serves the stage-1 hits ALONE, the
        cheapest rung. Coarse-only dicts carry ``stage="coarse"``; their
        scores are the coarse head's margins, not comparable to the fine
        stage's."""
        if mode == "cascade":
            return self.detect(frame, roi_boxes=roi_boxes)
        if mode != "coarse":
            raise ValueError(f"unknown degraded mode {mode!r}; "
                             f"'cascade' or 'coarse'")
        self.stats["frames"] += 1
        dets = []
        for d in self.coarse.detect_raw(self._frame(frame)).to_list():
            d = dict(d)
            d["stage"] = "coarse"
            dets.append(d)
        return dets

    def stream(self, frames, tracker=None) -> List[List[dict]]:
        """Video path: the cascade frame by frame, every live track's
        PREDICTED box promoted into the region planner first, so tracked
        objects bypass the coarse reject. Returns per-frame tracked
        dicts."""
        from .video import Tracker
        trk = Tracker() if tracker is None else tracker
        out = []
        for frame in frames:
            rois = [t.predicted for t in trk.tracks]
            dets = self.detect(frame, roi_boxes=rois)
            out.append(trk.update(dets))
        return out
