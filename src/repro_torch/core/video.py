"""Video-stream detection: frame-to-frame tracking over the batched
detector -- a copy of repro/core/video.py over the port's session.

The paper's §VI "future development" is a camera -> detection stream;
Gajjar et al. (arXiv:1709.00726) pair the per-frame detector with a
tracker so identities persist across frames and single-frame score
noise is smoothed out. This module is that layer, host-side on top of
the device-resident detection programs (core/detector.py):

  * `Tracker` -- greedy IoU association between constant-velocity
    track predictions and the current frame's detections, gated on
    `class_id` when detections carry one (multi-head results,
    DESIGN.md §13): a pedestrian track can never be stolen by an
    overlapping vehicle detection, and ids are allocated per class.
    Matched
    tracks update their box, an EMA-smoothed score, and an EMA-smoothed
    velocity; unmatched detections open new tracks; unmatched tracks
    coast on their prediction for up to `max_misses` frames before
    retiring. Pure numpy -- association is O(tracks x dets) on a few
    dozen boxes, not worth a device round-trip.
  * `VideoDetector` -- FrameDetector + Tracker. `step()` serves a live
    stream one frame at a time; `process_clip()` pushes a recorded clip
    through `detect_batch` in `batch_size` chunks (one device dispatch
    per chunk) and associates frames in order.

Detections gain a stable integer `track_id` plus the smoothed score;
`hits`/`misses` let callers gate on track confirmation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .detector import DetectorConfig, FrameDetector


def iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU on host. a: (N, 4), b: (M, 4) as (y0, x0, y1, x1).

    Numpy twin of detector.matrix_iou (same eps clamp) for the
    association step, which never touches the device.
    """
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    y0 = np.maximum(a[:, None, 0], b[None, :, 0])
    x0 = np.maximum(a[:, None, 1], b[None, :, 1])
    y1 = np.minimum(a[:, None, 2], b[None, :, 2])
    x1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(y1 - y0, 0.0) * np.maximum(x1 - x0, 0.0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-9)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    iou_match: float = 0.3       # min IoU for a track<->detection match
    max_misses: int = 2          # coasting frames before a track retires
    min_hits: int = 1            # matches before a track is "confirmed"
    score_alpha: float = 0.6     # EMA weight of the NEW score
    velocity_alpha: float = 0.7  # EMA weight of the NEW center velocity
    emit_coasting: bool = False  # also report unmatched-but-alive tracks


@dataclasses.dataclass
class Track:
    track_id: int
    box: np.ndarray              # (4,) float64 (y0, x0, y1, x1)
    velocity: np.ndarray         # (2,) float64 center (dy, dx) per frame
    score: float                 # EMA-smoothed SVM score
    scale: float                 # pyramid scale of the last matched det
    hits: int = 1                # total matched frames
    misses: int = 0              # consecutive unmatched frames
    class_id: Optional[int] = None   # detection head this track follows
    label: Optional[str] = None      # head name (multi-class results)

    @property
    def predicted(self) -> np.ndarray:
        """Constant-velocity prediction of the box for the next frame."""
        return self.box + np.concatenate([self.velocity, self.velocity])


class Tracker:
    """IoU-greedy multi-object tracker over per-frame detections."""

    def __init__(self, cfg: Optional[TrackerConfig] = None):
        # the default config is constructed PER INSTANCE: a
        # `cfg=TrackerConfig()` default argument would be one shared
        # object across every Tracker in the process (and TrackerConfig
        # is kept frozen so thresholds cannot be mutated out from under
        # a running tracker either way)
        self.cfg = TrackerConfig() if cfg is None else cfg
        self.tracks: List[Track] = []
        self._next_id = 0

    def update(self, detections: Sequence[Dict]) -> List[Dict]:
        """Associate one frame's detections; returns them with track ids.

        `detections` is the FrameDetector output (score-sorted dicts
        with box/score/scale, plus class_id/label on multi-head
        results). Greedy matching takes the globally highest-IoU
        (track, detection) pair first, so a detection can never steal a
        track from a better-overlapping detection; pairs whose class
        ids differ are masked out of the IoU matrix up front, so
        association and id allocation are per class.
        """
        cfg = self.cfg
        dets = list(detections)
        matched_t: set = set()
        matched_d: set = set()
        if self.tracks and dets:
            pred = np.stack([t.predicted for t in self.tracks])
            dbox = np.asarray([d["box"] for d in dets], np.float64)
            iou = iou_np(pred, dbox)
            # class gate: a track only matches detections of ITS class
            # (None matches None -- the single-head path is unchanged)
            tcls = np.asarray([-1 if t.class_id is None else t.class_id
                               for t in self.tracks])
            dcls = np.asarray([-1 if d.get("class_id") is None
                               else d["class_id"] for d in dets])
            iou[tcls[:, None] != dcls[None, :]] = -1.0
            while True:
                ti, di = np.unravel_index(np.argmax(iou), iou.shape)
                if iou[ti, di] < cfg.iou_match:
                    break
                self._match(self.tracks[ti], dets[di])
                matched_t.add(int(ti))
                matched_d.add(int(di))
                iou[ti, :] = -1.0
                iou[:, di] = -1.0

        survivors: List[Track] = []
        for ti, t in enumerate(self.tracks):
            if ti not in matched_t:
                t.misses += 1
                if t.misses > cfg.max_misses:
                    continue                      # retire
                t.box = t.predicted               # coast on the prediction
            survivors.append(t)
        for di, d in enumerate(dets):             # unmatched dets open tracks
            if di not in matched_d:
                survivors.append(
                    Track(self._next_id, np.asarray(d["box"], np.float64),
                          np.zeros(2), float(d["score"]),
                          float(d.get("scale", 1.0)),
                          class_id=d.get("class_id"),
                          label=d.get("label")))
                self._next_id += 1
        self.tracks = survivors

        out = [{"box": tuple(float(v) for v in t.box),
                "score": t.score, "scale": t.scale,
                "track_id": t.track_id, "hits": t.hits,
                "misses": t.misses,
                **({"class_id": t.class_id, "label": t.label}
                   if t.class_id is not None else {})}
               for t in self.tracks
               if t.hits >= cfg.min_hits
               and (t.misses == 0 or cfg.emit_coasting)]
        out.sort(key=lambda d: -d["score"])
        return out

    def _match(self, t: Track, det: Dict) -> None:
        new_box = np.asarray(det["box"], np.float64)
        a = self.cfg.velocity_alpha
        new_v = _center(new_box) - _center(t.box)
        t.velocity = a * new_v + (1.0 - a) * t.velocity
        t.box = new_box
        s = self.cfg.score_alpha
        t.score = s * float(det["score"]) + (1.0 - s) * t.score
        t.scale = float(det.get("scale", t.scale))
        t.hits += 1
        t.misses = 0


def _center(box: np.ndarray) -> np.ndarray:
    return np.asarray([(box[0] + box[2]) * 0.5, (box[1] + box[3]) * 0.5])


class VideoDetector:
    """Tracked detection stream: the camera->detection stream of §VI.

    Deprecated shim over `repro_torch.api.DetectionSession` (which owns
    the bucket programs and the typed Detections results): `step(frame)`
    serves a live stream; `process_clip(frames)` routes a recorded clip
    through `session.stream` (batched device path, `batch_size` frames
    per dispatch, association in frame order). Equivalence with the
    reference is pinned by tests/test_torch_video.py.
    """

    def __init__(self, svm, cfg: Optional[DetectorConfig] = None,
                 tracker: Optional[TrackerConfig] = None, device=None):
        # deferred import: repro_torch.api sits on top of this module
        from ..api.config import PipelineConfig
        from ..api.session import DetectionSession
        cfg = DetectorConfig() if cfg is None else cfg
        tracker = TrackerConfig() if tracker is None else tracker
        self.session = DetectionSession(
            svm, PipelineConfig(hog=cfg.hog, detector=cfg, tracker=tracker),
            device=device)
        self.tracker = Tracker(tracker)

    @property
    def detector(self) -> FrameDetector:
        """The session's device-program handle (legacy attribute)."""
        return self.session.detector

    def step(self, frame) -> List[Dict]:
        return self.tracker.update(self.session.detect(frame).to_list())

    def process_clip(self, frames, batch_size: int = 8) -> List[List[Dict]]:
        """(T, H, W[, 3]) stacked clip or list of frames -> per-frame
        tracked detections."""
        return [d.to_list()
                for d in self.session.stream(frames, batch_size=batch_size,
                                             tracker=self.tracker)]
