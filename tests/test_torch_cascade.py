"""The port's two-stage cascade (repro_torch.core.cascade) against the JAX
reference (tests/test_cascade.py's cases, on the CPU).

The region planner is host numpy in both packages and must plan the same
regions from the same boxes; its invariants (coverage of every dilated
candidate, snapping, the region cap) and threshold monotonicity are held
directly. The scheduler seams -- the empty-frame shortcut, the dense
fallback below ``min_frame_area``, tracker-ROI promotion past the coarse
gate, region-area accounting and the hysteresis detector -- run on the
port's detectors. End to end, the fine head is the golden SVM and the
coarse head the reference's own ``train_coarse_head`` (no mining round,
to keep the CPU time short), carried over through convert.py: the port's
cascade keeps the reference's boxes on seeded scenes, retains the dense
pass's pedestrians, tracks through coarse misses as the reference does,
and both packages' services answer the same on the full, cascade and
coarse rungs.
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import presets as j_presets
from repro.core import cascade as jc
from repro.core.detector import FrameDetector as JFrameDetector
from repro.core.video import Tracker as JTracker
from repro.serve.engine import DetectionService as JService
from repro_torch.api import DetectionSession
from repro_torch.convert import config_from_reference_dict, svm_from_numpy
from repro_torch.core import cascade as tc
from repro_torch.core.cascade import (CascadeConfig, CascadeDetector,
                                      coarse_detector, plan_regions)
from repro_torch.core.detector import DetectorConfig, FrameDetector
from repro_torch.core.video import Tracker
from repro_torch.data.synth_pedestrian import make_scene
from repro_torch.serve.engine import DetectionService

SEED = 11
GOLDEN = dict(np.load(pathlib.Path(__file__).parent / "golden"
                      / "hog_golden.npz"))
#: fine-stage scores, port against reference: f32 summation order
TOL = 1e-4
#: the golden head scores 0.2-0.45 on the seeded scenes' pedestrians
FINE_THRESHOLD = 0.2


def _rand_boxes(rng, n, h, w):
    y0 = rng.uniform(0, h * 0.8, n)
    x0 = rng.uniform(0, w * 0.8, n)
    return np.stack([y0, x0, y0 + rng.uniform(10, h * 0.3, n),
                     x0 + rng.uniform(10, w * 0.3, n)], -1).astype(np.float32)


def _covered(rect, regions, tol=1e-5):
    y0, x0, y1, x1 = rect
    return any(ry0 <= y0 + tol and rx0 <= x0 + tol
               and y1 <= ry1 + tol and x1 <= rx1 + tol
               for ry0, rx0, ry1, rx1 in regions)


def _dilated(boxes, frame_hw, cfg):
    h, w = frame_hw
    m = float(cfg.margin)
    return np.stack([
        np.clip(boxes[:, 0] - m, 0, h), np.clip(boxes[:, 1] - m, 0, w),
        np.clip(boxes[:, 2] + m, 0, h), np.clip(boxes[:, 3] + m, 0, w),
    ], axis=1)


# ------------------------------------------------------ planner invariants

@pytest.mark.parametrize("seed", range(20))
def test_planner_equals_reference_and_keeps_invariants(seed):
    rng = np.random.default_rng(SEED * 1000 + seed)
    h, w = int(rng.integers(200, 800)), int(rng.integers(200, 800))
    knobs = dict(margin=int(rng.integers(0, 48)),
                 snap=int(rng.choice([16, 32, 36, 64])),
                 max_regions=int(rng.integers(1, 6)))
    cfg = CascadeConfig(**knobs)
    boxes = _rand_boxes(rng, int(rng.integers(1, 20)), h, w)
    regions = plan_regions(boxes, (h, w), cfg)
    assert regions == jc.plan_regions(boxes, (h, w),
                                      jc.CascadeConfig(**knobs))
    assert 1 <= len(regions) <= cfg.max_regions
    for y0, x0, y1, x1 in regions:
        assert 0 <= y0 < y1 <= h and 0 <= x0 < x1 <= w
        assert y0 % cfg.snap == 0 and x0 % cfg.snap == 0
        assert y1 % cfg.snap == 0 or y1 == h
        assert x1 % cfg.snap == 0 or x1 == w
    for rect in _dilated(boxes, (h, w), cfg):
        assert _covered(rect, regions), (rect, regions)


@pytest.mark.parametrize("seed", range(10))
def test_threshold_monotonicity(seed):
    """The candidates at a tight threshold are a subset of those at a
    loose one, and the loose plan covers every tight candidate."""
    rng = np.random.default_rng(SEED * 2000 + seed)
    h = w = 640
    cfg = CascadeConfig(margin=24, snap=32,
                        max_regions=int(rng.integers(1, 5)))
    boxes = _rand_boxes(rng, 16, h, w)
    scores = rng.uniform(-1.0, 1.0, len(boxes)).astype(np.float32)
    tight_boxes, loose_boxes = boxes[scores > 0.4], boxes[scores > -0.2]
    assert set(map(tuple, tight_boxes)) <= set(map(tuple, loose_boxes))
    if len(tight_boxes):
        loose_regions = plan_regions(loose_boxes, (h, w), cfg)
        for rect in _dilated(tight_boxes, (h, w), cfg):
            assert _covered(rect, loose_regions)


def test_planner_edge_cases():
    assert plan_regions(np.zeros((0, 4), np.float32), (480, 640)) == []
    cfg = CascadeConfig(margin=16, snap=32, max_regions=4)
    r = plan_regions(np.asarray([[100, 100, 230, 166]], np.float32),
                     (480, 640), cfg)
    assert len(r) == 1 and _covered((84, 84, 246, 182), r)
    boxes = np.asarray([[0, 0, 50, 50], [400, 500, 470, 620]], np.float32)
    r1 = plan_regions(boxes, (480, 640),
                      dataclasses.replace(cfg, max_regions=1))
    assert len(r1) == 1
    for rect in _dilated(boxes, (480, 640), cfg):
        assert _covered(rect, r1)
    # regions clamp to the frame and never come back empty
    assert plan_regions(np.asarray([[-50, -50, -10, -10]], np.float32),
                        (100, 100), CascadeConfig(margin=0)) == []


def test_config_and_coarse_geometry_match_the_reference():
    assert dataclasses.asdict(CascadeConfig()) == \
        dataclasses.asdict(jc.CascadeConfig())
    ref = j_presets("resilient")
    cfg = config_from_reference_dict(ref.to_dict())
    assert cfg.cascade == CascadeConfig(enabled=True)
    assert cfg.to_dict() == ref.to_dict()
    ch = tc.coarse_hog(cfg.hog)
    assert (ch.window_h, ch.window_w, ch.blocks_hw, ch.n_features) == \
        (66, 34, (7, 3), 756)


# --------------------------------------------------------- scheduler seams

def _rand_head(rng, f):
    return {"w": rng.normal(0, 0.05, (f,)).astype(np.float32),
            "b": np.float32(0.0)}


def _fine_and_coarse(rng, fine_thr=-2.0, coarse_thr=0.0, **casc_kw):
    casc = CascadeConfig(coarse_threshold=coarse_thr, **casc_kw)
    fine_cfg = DetectorConfig(score_threshold=fine_thr)
    fine = FrameDetector(_rand_head(rng, 3780), fine_cfg, "cpu")
    coarse = coarse_detector(_rand_head(rng, 756), fine_cfg, casc, "cpu")
    return CascadeDetector(fine, coarse, casc), fine


def test_empty_frame_shortcut():
    rng = np.random.default_rng(SEED)
    casc, _ = _fine_and_coarse(rng, coarse_thr=1e9)
    assert casc.detect(rng.integers(0, 255, (240, 320, 3), np.uint8)) == []
    assert casc.stats["frames_empty"] == 1 and casc.stats["regions"] == 0


def test_dense_fallback_below_min_area():
    rng = np.random.default_rng(SEED + 1)
    casc, fine = _fine_and_coarse(rng, coarse_thr=1e9, min_frame_area=10**9)
    frame = rng.integers(0, 255, (192, 128, 3), np.uint8)
    assert casc.detect(frame) == fine.detect_raw(frame).to_list()
    assert casc.stats["frames_dense"] == 1


def test_roi_promotion_bypasses_coarse_gate_and_area_accounting():
    """With the coarse stage rejecting everything, a promoted ROI still
    has its neighbourhood scored by the fine stage; every box lands inside
    the planned region, in frame coordinates, equal to a direct fine pass
    on the crop; the region's share of the frame is accounted."""
    rng = np.random.default_rng(SEED + 2)
    casc, fine = _fine_and_coarse(rng, coarse_thr=1e9, margin=24, snap=32)
    frame = rng.integers(0, 255, (320, 320, 3), np.uint8)
    roi = (96.0, 96.0, 240.0, 180.0)
    out = casc.detect(frame, roi_boxes=[roi])
    assert out, "fine stage at threshold -2 must fire inside the ROI"
    assert casc.stats["regions"] == 1
    (ry0, rx0, ry1, rx1), = plan_regions(np.asarray([roi], np.float32),
                                         (320, 320), casc.cfg)
    assert casc.stats["region_area_frac"] == pytest.approx(
        (ry1 - ry0) * (rx1 - rx0) / (320 * 320))
    for d in out:
        y0, x0, y1, x1 = d["box"]
        assert ry0 <= y0 and rx0 <= x0 and y1 <= ry1 and x1 <= rx1
    crop = {tuple(round(v + o, 3) for v, o in
                  zip(d["box"], (ry0, rx0, ry0, rx0)))
            for d in fine.detect_raw(frame[ry0:ry1, rx0:rx1]).to_list()}
    assert {tuple(round(v, 3) for v in d["box"]) for d in out} <= crop


def test_fine_hysteresis_builds_looser_crop_detector():
    svm = {"w": np.zeros(3780, np.float32), "b": np.float32(0.0)}
    fine = FrameDetector(svm, DetectorConfig(score_threshold=4.0), "cpu")
    assert CascadeDetector(fine, fine, CascadeConfig())._crop_fine is fine
    casc = CascadeDetector(fine, fine, CascadeConfig(fine_hysteresis=1.5))
    assert casc._crop_fine is not fine
    assert casc._crop_fine.cfg.score_threshold == pytest.approx(2.5)
    assert casc._crop_fine.cfg.scales == fine.cfg.scales
    assert casc._crop_fine.device == fine.device
    with pytest.raises(ValueError, match="degraded mode"):
        casc.detect_degraded(np.zeros((140, 70), np.uint8), "dense")


# ----------------------------------------- end to end against the reference

@pytest.fixture(scope="module")
def pair():
    """The cascade preset in both packages: the golden SVM as the fine
    head (at FINE_THRESHOLD: its scores on these scenes stay under the
    preset's 0.5), the reference's coarse head (trained without a mining
    round) as the coarse head, each package's CascadeDetector over
    them."""
    ref = j_presets("cascade")
    ref = ref.replace(detector=dataclasses.replace(
        ref.detector, score_threshold=FINE_THRESHOLD))
    cfg = config_from_reference_dict(ref.to_dict())
    coarse, _ = jc.train_coarse_head(ref.hog, ref.train, n_pos=300,
                                     n_neg=200, rng=np.random.default_rng(3),
                                     hard_negative_rounds=0)
    coarse = {k: np.asarray(v) for k, v in coarse.items()}
    fine = {"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]}
    jfine = JFrameDetector({k: jnp.asarray(v) for k, v in fine.items()},
                           ref.detector)
    jcasc = jc.CascadeDetector(jfine, jc.coarse_detector(
        {k: jnp.asarray(v) for k, v in coarse.items()}, ref.detector,
        ref.cascade), ref.cascade)
    sess = DetectionSession(svm_from_numpy(fine, device="cpu"), cfg,
                            device="cpu")
    casc = sess.cascade(coarse_svm=coarse)
    return sess, casc, jcasc


def _scenes(seed, n, n_people=2):
    rng = np.random.default_rng(seed)
    return [make_scene(rng, 320, 320, n_people=n_people,
                       region=(0, 0, 320, 320)) for _ in range(n)]


def _same_dets(got, want):
    key = (lambda d: (d.get("class_id"), d["box"]))
    assert sorted(map(key, got)) == sorted(map(key, want))
    by = {key(d): d["score"] for d in want}
    assert all(abs(d["score"] - by[key(d)]) <= TOL for d in got)


def _iou(a, b):
    y0, x0 = max(a[0], b[0]), max(a[1], b[1])
    y1, x1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, y1 - y0) * max(0.0, x1 - x0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
    return inter / (ua - inter + 1e-9)


def _retained(full, dets, tboxes):
    """Dense-pass pedestrian detections a cascade kept: matched directly
    (IoU >= 0.5) or through a cascade box on the same pedestrian (a crop's
    HOG grid is offset, so its NMS may keep a shifted box)."""
    kept = 0
    for f in full:
        gt = max(range(len(tboxes)), key=lambda j: _iou(f["box"], tboxes[j]))
        kept += any(_iou(f["box"], c["box"]) >= 0.5
                    or _iou(c["box"], tboxes[gt]) >= 0.4 for c in dets)
    return kept


def test_cascade_keeps_the_references_boxes_and_retains(pair):
    """On seeded scenes the port's cascade keeps the reference cascade's
    boxes (scores within the f32 tolerance) with the same stats, and
    retains the same dense-pass pedestrian detections as the reference's
    cascade does. (With these quickly made heads -- an unmined coarse
    head, the golden fine head under its preset threshold -- retention is
    the heads' property, so it is held to the reference's, not to the
    trained deployment's 0.99.)"""
    sess, casc, jcasc = pair
    kept = jkept = total = 0
    for scene, truth in _scenes(SEED + 4, 2):
        got, want = casc.detect(scene), jcasc.detect(scene)
        _same_dets(got, want)
        tboxes = [(y, x, y + th, x + tw) for y, x, th, tw in truth]
        full = [d for d in sess.detect(scene).to_list()
                if any(_iou(d["box"], t) >= 0.4 for t in tboxes)]
        total += len(full)
        kept += _retained(full, got, tboxes)
        jkept += _retained(full, want, tboxes)
    for k in ("frames", "frames_empty", "frames_dense", "regions"):
        assert casc.stats[k] == jcasc.stats[k], k
    assert casc.stats["region_area_frac"] == pytest.approx(
        jcasc.stats["region_area_frac"])
    assert total > 0, "dense pass found nothing -- scene too hard"
    assert kept == jkept and kept > 0, (kept, jkept, total)


def test_cascade_stream_tracks_through_coarse_misses(pair):
    """A blinded coarse stage (threshold 1e9) still detects a tracked
    pedestrian through its promoted ROI, frame after frame, in both
    packages alike."""
    sess, casc, jcasc = pair
    (scene, _), = _scenes(SEED + 5, 1, n_people=1)
    first = casc.detect(scene)
    assert first, "the cascade must find the pedestrian first"
    trk, jtrk = Tracker(), JTracker()
    trk.update(first)
    jtrk.update(jcasc.detect(scene))
    blind = CascadeDetector(casc.fine, FrameDetector(
        casc.coarse.svm, dataclasses.replace(casc.coarse.cfg,
                                             score_threshold=1e9), "cpu"),
        casc.cfg)
    jblind = jc.CascadeDetector(jcasc.fine, JFrameDetector(
        jcasc.coarse.svm, dataclasses.replace(jcasc.coarse.cfg,
                                              score_threshold=1e9)),
        jcasc.cfg)
    out = blind.stream([scene, scene], tracker=trk)
    want = jblind.stream([scene, scene], tracker=jtrk)
    assert out[0] and all("track_id" in d for d in out[0])
    for o, w in zip(out, want):
        assert [(d["track_id"], d["box"]) for d in o] == \
            [(d["track_id"], d["box"]) for d in w]
    assert blind.stats["frames_empty"] == 0 and blind.stats["regions"] >= 2


def test_coarse_rung_serves_the_coarse_head_alone(pair):
    _, casc, jcasc = pair
    (scene, _), = _scenes(SEED + 6, 1)
    got = casc.detect_degraded(scene, "coarse")
    assert got and all(d["stage"] == "coarse" for d in got)
    _same_dets(got, jcasc.detect_degraded(scene, "coarse"))
    assert casc.detect_degraded(scene, "cascade") == casc.detect(scene)


def test_services_answer_alike_on_every_rung(pair):
    """Both packages' DetectionService with cascade rungs, each forced to
    the full, cascade and coarse rung in turn on the same frames: the
    same rung reported and the same detections."""
    sess, casc, jcasc = pair
    scenes = [s for s, _ in _scenes(SEED + 7, 2)]
    svc = DetectionService(sess.svm, cfg=sess.config.hog,
                           detector=sess.config.detector,
                           frame_detector=sess.detector, cascade=casc,
                           device="cpu")
    jsvc = JService({"w": jnp.asarray(GOLDEN["svm_w"]),
                     "b": jnp.asarray(GOLDEN["svm_b"])},
                    cfg=jcasc.fine.cfg.hog, detector=jcasc.fine.cfg,
                    frame_detector=jcasc.fine, cascade=jcasc)
    assert svc._ladder.rungs == jsvc._ladder.rungs == \
        ("full", "cascade", "coarse")
    svc.start()
    jsvc.start()
    try:
        for level, rung in enumerate(svc._ladder.rungs):
            svc._ladder.level = jsvc._ladder.level = level
            got = svc.detect_frames(scenes, timeout=300)
            want = jsvc.detect_frames(scenes, timeout=300)
            for g, w in zip(got, want):
                assert g["degraded_mode"] == w["degraded_mode"] == rung
                _same_dets(g["detections"], w["detections"])
    finally:
        svc.stop()
        jsvc.stop()
    assert svc.stats["frames_degraded"] == 4
