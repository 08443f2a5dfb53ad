"""Hard-negative mining on synthetic scenes (Dalal-Triggs bootstrapping),
the port of repro/data/mining.py.

A head trained only on window-sized synthetic crops lights up on the
smoother background of the pyramid's downscaled levels. Bootstrapping
sweeps the current head over person-free scenes at a very loose
threshold, crops every firing window back to training-window geometry,
and retrains with those crops as negatives
(``DetectionSession.train(hard_negative_rounds=N)``).

The sweep is the port's ``FrameDetector.detect_raw``: on the card, the
dense kernels of the configured backend with the head being trained.
Each crop is resized to the window as ``jax.image.resize(..., "linear")``
does -- the same weights (``core/detector.py:_resize_weights``,
antialiased when downscaling), one spatial axis at a time -- summed in
f64 on the host and rounded once to f32, then clipped and truncated to
uint8 as the reference's ``astype``. The reference sums in f32 in its
own order, so a value within an ulp of an integer can truncate to the
neighbouring code: crops agree within one code.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

MINE_THRESHOLD = -1.0      # loose sweep gate: mine anything remotely firing


def resize_crop(crop: np.ndarray, wh: int, ww: int) -> np.ndarray:
    """(h, w, 3) crop -> (wh, ww, 3) f32, jax.image.resize's "linear"
    weights on each spatial axis whose size changes, summed in f64."""
    from ..core.detector import _resize_weights
    x = crop.astype(np.float64)
    h, w = x.shape[:2]
    if h != wh:
        x = np.einsum("ih,hwc->iwc", _resize_weights(h, wh).astype(np.float64),
                      x)
    if w != ww:
        x = np.einsum("jw,iwc->ijc", _resize_weights(w, ww).astype(np.float64),
                      x)
    return x.astype(np.float32)


def mine_hard_negatives(svm, det_cfg, n_scenes: int,
                        rng: np.random.Generator,
                        scene_hw: Tuple[int, int] = (480, 640),
                        threshold: float = MINE_THRESHOLD,
                        window_hw: Optional[Tuple[int, int]] = None,
                        device=None) -> np.ndarray:
    """Sweep ``svm`` over ``n_scenes`` person-free synthetic scenes with
    the given DetectorConfig at a LOOSE threshold, on ``device`` (CUDA
    unless the CPU is asked for), and return every firing window as a
    training-geometry crop: (N, wh, ww, 3) uint8, where (wh, ww) defaults
    to det_cfg's HOG window. N shrinks round over round."""
    from ..core.detector import FrameDetector
    from .synth_pedestrian import make_scene

    h, w = int(scene_hw[0]), int(scene_hw[1])
    wh, ww = window_hw or (det_cfg.hog.window_h, det_cfg.hog.window_w)
    det = FrameDetector(svm, dataclasses.replace(
        det_cfg, score_threshold=float(threshold), class_thresholds=()),
        device)
    crops = []
    for _ in range(int(n_scenes)):
        scene, _ = make_scene(rng, h, w, n_people=0)
        for d in det.detect_raw(scene).to_list():
            y0, x0, y1, x1 = [int(round(v)) for v in d["box"]]
            y0, x0 = max(0, y0), max(0, x0)
            y1, x1 = min(h, y1), min(w, x1)
            if y1 - y0 < wh // 3 or x1 - x0 < ww // 3:
                continue
            crops.append(resize_crop(scene[y0:y1, x0:x1], wh, ww))
    if not crops:
        return np.zeros((0, wh, ww, 3), np.uint8)
    return np.clip(np.stack(crops), 0, 255).astype(np.uint8)
