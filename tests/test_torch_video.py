"""The port's tracked clips (repro_torch.core.video: iou_np, Tracker,
VideoDetector; DetectionSession.stream; data.synth_pedestrian.make_clip)
against the JAX reference's.

The tracker is host numpy in both packages, so given the same detections
it must give the same tracks, ids and smoothed scores exactly. End to
end, both sessions stream the same seeded ``make_clip`` clip with the
golden SVM weights; the reference runs its Pallas kernels in interpret
mode on the CPU, the port its plain versions (device="cpu"). Track ids,
boxes, hits and misses must be identical; scores agree within the
session tolerance of tests/test_torch_session.py.
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import DetectionSession as JSession
from repro.api import presets as j_presets
from repro.core import video as jvideo
from repro.data import synth_pedestrian as jsynth
from repro_torch.api import DetectionSession
from repro_torch.convert import config_from_reference_dict
from repro_torch.core import video as tvideo
from repro_torch.core.detector import DetectorConfig
from repro_torch.data import synth_pedestrian as tsynth

GOLDEN = dict(np.load(pathlib.Path(__file__).parent / "golden"
                      / "hog_golden.npz"))
SVM = {"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]}
CLIP = dict(n_frames=5, n_people=1, h=160, w=128, frame_noise=4.0)


def _clip(seed=13, **kw):
    cfg = dict(CLIP, **kw)
    return (tsynth.make_clip(np.random.default_rng(seed),
                             tsynth.ClipConfig(**cfg)),
            jsynth.make_clip(np.random.default_rng(seed),
                             jsynth.ClipConfig(**cfg)))


def _truth_dets(truths, jitter=None, drop=()):
    """make_clip truth boxes as detector-style dicts (as
    tests/test_video_batch.py builds them)."""
    rng = None if jitter is None else np.random.default_rng(jitter)
    out = []
    for t, boxes in enumerate(truths):
        dets = []
        for g in boxes:
            if (t, g["id"]) in drop:
                continue
            box = np.asarray(g["box"], np.float64)
            if rng is not None:
                box += rng.normal(0, 1.0, 4)
            dets.append({"box": tuple(box), "score": float(1 + t % 3),
                         "scale": 1.0})
        out.append(dets)
    return out


def _same_tracked(got, want, atol=0.0):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [d["track_id"] for d in a] == [d["track_id"] for d in b]
        assert [d["box"] for d in a] == [d["box"] for d in b]
        assert [(d["hits"], d["misses"]) for d in a] \
            == [(d["hits"], d["misses"]) for d in b]
        np.testing.assert_allclose([d["score"] for d in a],
                                   [d["score"] for d in b], rtol=0,
                                   atol=atol)


def test_make_clip_is_the_reference_clip():
    (tf, tt), (jf, jt) = _clip(seed=11, n_frames=6, n_people=2, h=240,
                               w=320)
    np.testing.assert_array_equal(tf, jf)
    assert tt == jt
    assert tsynth.ClipConfig() == tsynth.ClipConfig(
        **dataclasses.asdict(jsynth.ClipConfig()))


def test_iou_np_matches_reference():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 100, (7, 4))
    a[:, 2:] += a[:, :2]
    b = rng.uniform(0, 100, (5, 4))
    b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(tvideo.iou_np(a, b), jvideo.iou_np(a, b))


@pytest.mark.parametrize("tracker", [
    {}, {"max_misses": 1, "emit_coasting": True}, {"min_hits": 2},
    {"iou_match": 0.5, "score_alpha": 0.3, "velocity_alpha": 0.2}],
    ids=["default", "coasting", "min_hits", "tight"])
def test_tracker_matches_reference(tracker):
    """Same detections in, same tracks out: on a jittered two-person clip
    with one person dropped for a frame and a stray detection."""
    (_, truths), _ = _clip(seed=11, n_frames=10, n_people=2, h=320, w=480,
                           speed=5.0)
    dets = _truth_dets(truths, jitter=1, drop={(3, 0), (4, 0)})
    dets[6].append({"box": (5.0, 5.0, 135.0, 71.0), "score": 0.5,
                    "scale": 0.8})
    trk = tvideo.Tracker(tvideo.TrackerConfig(**tracker))
    ref = jvideo.Tracker(jvideo.TrackerConfig(**tracker))
    for d in dets:
        got, want = trk.update(d), ref.update(d)
        assert got == want
    assert trk._next_id == ref._next_id >= 2


def test_tracker_config_reaches_the_session():
    ref = j_presets("default").replace(
        tracker=jvideo.TrackerConfig(min_hits=2, max_misses=5))
    cfg = config_from_reference_dict(ref.to_dict())
    assert cfg.tracker == tvideo.TrackerConfig(min_hits=2, max_misses=5)
    assert cfg.to_dict() == ref.to_dict()
    sess = DetectionSession(SVM, cfg, device="cpu")
    assert sess.config.tracker.min_hits == 2


@pytest.mark.parametrize("preset,tol", [("default", 1e-4), ("quant", 2e-3)])
def test_stream_matches_reference_session(preset, tol):
    """A clip through the batched path in chunks of 3 (a batch of 3, then
    one of 2) and the tracker: the reference session's tracks."""
    (clip, _), (jclip, _) = _clip()
    np.testing.assert_array_equal(clip, jclip)
    ref = j_presets(preset)
    ref = ref.replace(detector=dataclasses.replace(
        ref.detector, score_threshold=0.1, scales=(1.0, 0.8),
        batch_chunk=1 << 10))
    cfg = config_from_reference_dict(ref.to_dict())
    jsess = JSession({"w": jnp.asarray(SVM["w"]),
                      "b": jnp.asarray(SVM["b"])}, ref)
    tsess = DetectionSession(SVM, cfg, device="cpu")
    want = [d.to_list() for d in jsess.stream(list(jclip), batch_size=3)]
    got = [d.to_list() for d in tsess.stream(list(clip), batch_size=3)]
    assert all(got), "every frame must keep a track"
    _same_tracked(got, want, atol=tol)


def test_process_clip_and_step_match_reference():
    """VideoDetector.process_clip (the session's stream) and step (frame
    by frame) give the reference's ids, and each other's."""
    (clip, _), _ = _clip(seed=14)
    cfg = DetectorConfig(score_threshold=-10.0, scales=(1.0,))
    vid = tvideo.VideoDetector(SVM, cfg, device="cpu")
    tracked = vid.process_clip(list(clip), batch_size=3)
    assert len(tracked) == 5 and all(tracked)
    for dets in tracked:
        for d in dets:
            assert {"box", "score", "scale", "track_id", "hits",
                    "misses"} <= set(d)
    jvid = jvideo.VideoDetector(
        {"w": jnp.asarray(SVM["w"]), "b": jnp.asarray(SVM["b"])},
        jvideo.DetectorConfig(score_threshold=-10.0, scales=(1.0,),
                              batch_chunk=1 << 10))
    _same_tracked(tracked, jvid.process_clip(list(clip), batch_size=3),
                  atol=1e-4)
    vid2 = tvideo.VideoDetector(SVM, cfg, device="cpu")
    stepped = [vid2.step(f) for f in clip]
    _same_tracked(tracked, stepped, atol=1e-5)
    assert vid2.detector is vid2.session.detector
