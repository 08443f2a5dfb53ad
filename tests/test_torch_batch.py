"""The port's batched frame path (FrameDetector.detect_batch_raw,
DetectionSession.detect_batch, the chunk schedule, the autotune and its
disk cache, batched Detections) against the JAX reference's detect_batch.

Both sides see the same seeded synthetic frames (RGB uint8) and the
golden SVM weights (tests/golden/hog_golden.npz); the port's
configuration is the reference's ``to_dict()`` carried over. The
reference runs its Pallas kernels in interpret mode on the CPU, the port
its plain versions (device="cpu"). Tolerances are those of
tests/test_torch_session.py: boxes and keep masks identical, scores
within 1e-4 (f32 descriptors) or 2e-3 (bf16 descriptors, and the fixed
chain's int8 code steps).
"""
import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DetectionSession as JSession
from repro.api import presets as j_presets
from repro_torch.api import DetectionSession, Detections
from repro_torch.convert import config_from_reference_dict
from repro_torch.core import autotune_cache
from repro_torch.core import detector as tdet
from repro_torch.data.synth_pedestrian import make_scene

GOLDEN = dict(np.load(pathlib.Path(__file__).parent / "golden"
                      / "hog_golden.npz"))
SVM = {"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]}
THRESHOLD = 0.1
SCALES = (1.0, 0.8)

# (preset, backend override, frame (H, W), batch, score tolerance)
CASES = [
    ("paper", "kernel", (160, 128), 4, 1e-4),
    ("perf", None, (192, 128), 3, 2e-3),
    ("quant", None, (160, 128), 3, 2e-3),
    ("quant", "kernel", (192, 128), 3, 2e-3),
    ("default", None, (160, 128), 4, 1e-4),
]
IDS = [f"{p}{'+' + b if b else ''}-{h}x{w}-B{n}"
       for p, b, (h, w), n, _ in CASES]


def _configs(preset, backend=None, **change):
    ref = j_presets(preset)
    det = dataclasses.replace(ref.detector, score_threshold=THRESHOLD,
                              scales=SCALES, **change,
                              **({"backend": backend} if backend else {}))
    ref = ref.replace(detector=det)
    return ref, config_from_reference_dict(ref.to_dict())


def _frames(hw, n, seed=0, people=1):
    return [make_scene(np.random.default_rng(seed + i), *hw,
                       n_people=people)[0] for i in range(n)]


def _jsession(jcfg):
    # the reference's own chunk is fixed (its autotune would compile
    # every candidate); its chunk layouts agree (tests/test_video_batch.py)
    jcfg = jcfg.replace(detector=dataclasses.replace(
        jcfg.detector, batch_chunk=1 << 10))
    return JSession({"w": jnp.asarray(SVM["w"]),
                     "b": jnp.asarray(SVM["b"])}, jcfg)


def _same_frame(td, jd, tol):
    """One frame of the port against one frame of the reference."""
    assert int(td._n_valid) == int(jd._n_valid)
    jtop, ttop = np.asarray(jd._scores), td._scores.numpy()
    np.testing.assert_allclose(ttop, jtop, rtol=0, atol=tol)
    finite = np.isfinite(jtop)
    tidx, jidx = td._index.numpy(), np.asarray(jd._index)
    if np.all(np.abs(np.diff(jtop[finite])) > 2 * tol):
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_array_equal(td._keep.numpy(), np.asarray(jd._keep))
    else:
        # a near-tie within tolerance may swap neighbours in top-k order
        assert set(tidx[finite].tolist()) == set(jidx[finite].tolist())
    tl, jl = td.to_list(), jd.to_list()
    assert [d["box"] for d in tl] == [d["box"] for d in jl]
    assert [d["scale"] for d in tl] == [d["scale"] for d in jl]
    np.testing.assert_allclose([d["score"] for d in tl],
                               [d["score"] for d in jl], rtol=0, atol=tol)


def _same_lists(a, b, atol=1e-5):
    """Per-frame dict lists: boxes and scales identical, scores close."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert [d["box"] for d in x] == [d["box"] for d in y]
        assert [d["scale"] for d in x] == [d["scale"] for d in y]
        np.testing.assert_allclose([d["score"] for d in x],
                                   [d["score"] for d in y], rtol=0,
                                   atol=atol)


@pytest.fixture(autouse=True)
def _fresh_autotune():
    tdet._AUTOTUNE.clear()
    autotune_cache._reset_for_tests()
    yield
    tdet._AUTOTUNE.clear()
    autotune_cache._reset_for_tests()


# ------------------------------------------------ against the reference

@pytest.mark.parametrize("preset,backend,hw,n,tol", CASES, ids=IDS)
def test_detect_batch_matches_reference(preset, backend, hw, n, tol):
    jcfg, tcfg = _configs(preset, backend)
    frames = _frames(hw, n, seed=sum(hw))
    jd = _jsession(jcfg).detect_batch(frames)
    td = DetectionSession(SVM, tcfg, device="cpu").detect_batch(frames)
    assert td.batched and td.batch_size == n == jd.batch_size
    assert tuple(td._scores.shape) == np.shape(jd._scores)
    np.testing.assert_array_equal(td.saturated, jd.saturated)
    kept = 0
    for i in range(n):
        _same_frame(td.frame(i), jd.frame(i), tol)
        kept += len(jd.frame(i).to_list())
    assert kept >= n                 # not vacuous: boxes were kept


@pytest.mark.parametrize("preset,backend,hw,n,tol", CASES, ids=IDS)
def test_detect_batch_equals_sequential(preset, backend, hw, n, tol):
    """The batch runs the single frame's program with a batch axis: its
    per-frame results are the sequential ones (one wide step; the other
    schedules are test_chunk_layouts_agree's, the autotune's below)."""
    _, tcfg = _configs(preset, backend, batch_chunk=1 << 10)
    sess = DetectionSession(SVM, tcfg, device="cpu")
    frames = _frames(hw, n, seed=sum(hw))
    bat = sess.detect_batch(frames)
    _same_lists([sess.detect(f).to_list() for f in frames], bat.to_list())
    # a stacked array runs the same program as the list
    _same_lists(bat.to_list(), sess.detect_batch(np.stack(frames)).to_list())


@pytest.mark.parametrize("chunk", [1, 2, 3, 8])
def test_chunk_layouts_agree(chunk):
    """Frame by frame (1), chunk-wide steps plus a remainder (2 of 3) and
    one wide step (>= B) are one numerics, different schedules."""
    _, base_cfg = _configs("default", batch_chunk=1 << 10)
    frames = _frames((160, 128), 3, seed=5)
    want = DetectionSession(SVM, base_cfg, device="cpu").detect_batch(frames)
    _, cfg = _configs("default", batch_chunk=chunk)
    got = DetectionSession(SVM, cfg, device="cpu").detect_batch(frames)
    _same_lists(want.to_list(), got.to_list())
    assert not tdet._AUTOTUNE                        # no probe ran


def test_chunked_schedule_steps_like_lax_map():
    calls = []

    def one(frames, wv, bv, hws):
        calls.append((int(frames.shape[0]), tuple(hws)))
        return frames * 2, frames[:, 0]

    frames = torch.arange(5)[:, None].repeat(1, 2)
    hws = tuple((i, i) for i in range(5))
    out = tdet._chunked_schedule(one, 2, 5)(frames, None, None, hws)
    assert calls == [(2, hws[:2]), (2, hws[2:4]), (1, hws[4:])]
    assert torch.equal(out[0], frames * 2)
    assert tdet._chunked_schedule(one, 5, 5) is one
    assert tdet._chunked_schedule(one, 9, 5) is one


def test_mixed_true_sizes_share_bucket_match_reference():
    """Frames of different true sizes that pad to one bucket batch
    together through the eager gray and an edge pad; each keeps its own
    inside mask."""
    jcfg, tcfg = _configs("default")
    rng = np.random.default_rng(9)
    frames = [make_scene(rng, 150, 100, n_people=1)[0],
              make_scene(rng, 160, 128, n_people=1)[0],
              make_scene(rng, 140, 120, n_people=1)[0]]
    td = DetectionSession(SVM, tcfg, device="cpu").detect_batch(frames)
    jd = _jsession(jcfg).detect_batch(frames)
    for i, (h, w) in enumerate([(150, 100), (160, 128), (140, 120)]):
        _same_frame(td.frame(i), jd.frame(i), 1e-4)
        for d in td.frame(i).to_list():
            assert d["box"][2] <= h + 1e-3 and d["box"][3] <= w + 1e-3
    assert sum(len(x) for x in td.to_list()) >= 2


def test_mixed_buckets_and_bare_rgb_frame_raise():
    sess = DetectionSession(SVM, _configs("default")[1], device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        sess.detect_batch([np.zeros((160, 128, 3), np.uint8),
                           np.zeros((224, 160, 3), np.uint8)])
    with pytest.raises(ValueError, match="single RGB frame"):
        sess.detect_batch(np.zeros((160, 128, 3), np.uint8))
    with pytest.raises(ValueError, match="frame"):
        sess.detect_batch([np.zeros((5,), np.uint8)])


def test_empty_and_too_small_batches():
    sess = DetectionSession(SVM, _configs("default")[1], device="cpu")
    d = sess.detect_batch([])
    assert d.batched and d.batch_size == 0 and d.to_list() == []
    assert sess.detect_batch(np.zeros((0, 160, 128, 3), np.uint8)) \
        .to_list() == []
    small = sess.detect_batch([np.zeros((64, 64, 3), np.uint8)] * 3)
    assert small.to_list() == [[], [], []]
    np.testing.assert_array_equal(small.saturated, [False] * 3)


# ------------------------------------------------ batched Detections

def test_frame_stack_and_saturated_behave_as_the_reference():
    """A small max_detections saturates some frames: the (B,) flags, the
    frame slices, stack and from_list act as the reference's."""
    jcfg, tcfg = _configs("default", max_detections=8)
    frames = _frames((160, 128), 3, seed=11, people=2)
    td = DetectionSession(SVM, tcfg, device="cpu").detect_batch(frames)
    jd = _jsession(jcfg).detect_batch(frames)
    np.testing.assert_array_equal(td.saturated, jd.saturated)
    assert td.saturated.any() and td.saturated.dtype == bool
    # frame() slices device tensors (no decode ran yet)
    f0 = td.frame(0)
    assert td._lists is None and isinstance(f0._scores, torch.Tensor)
    assert f0.saturated == jd.frame(0).saturated
    st = Detections.stack([td.frame(i) for i in range(3)])
    assert st.batch_size == 3 and torch.equal(st._scores, td._scores)
    with pytest.warns(RuntimeWarning, match="max_detections=8"):
        lists = st.to_list()
    with pytest.warns(RuntimeWarning):
        jl = jd.to_list()
    _same_lists(lists, jl, atol=1e-4)
    assert [len(x) for x in td] == [len(x) for x in jl]
    with pytest.raises(ValueError, match="single-frame"):
        Detections.stack([td])
    with pytest.raises(ValueError, match="per-frame"):
        td.boxes
    dets = [{"box": (1.0, 2.0, 131.0, 68.0), "score": 2.5, "scale": 0.8,
             "track_id": 7, "hits": 3}]
    fl = Detections.from_list(dets)
    assert fl.to_list() == dets and len(fl) == 1 and not fl.saturated
    assert fl.to_list()[0]["track_id"] == 7
    np.testing.assert_array_equal(fl.boxes, [[1, 2, 131, 68]])


# ------------------------------------------------ autotune

@pytest.mark.parametrize("n,candidates", [(3, {1, 3}), (6, {1, 4, 6})])
def test_autotune_picks_the_fastest_candidate(n, candidates):
    _, tcfg = _configs("perf")
    assert tcfg.detector.batch_chunk == 0
    sess = DetectionSession(SVM, tcfg, device="cpu")
    frames = _frames((160, 128), n, seed=2)
    got = sess.detect_batch(frames)
    (key, entry), = tdet.autotune_report().items()
    assert key == f"160x128->160x128 B={n} mesh=data:1 [rgb-uint8] on cpu"
    assert set(entry["probe_ms"]) == candidates
    assert entry["source"] == "probe"
    assert entry["chunk"] == min(entry["probe_ms"], key=entry["probe_ms"].get)
    assert autotune_cache.stats()["probes"] == 1
    # the second call reuses the decision from memory, and the chosen
    # schedule gives what every other schedule gives
    again = sess.detect_batch(frames)
    assert autotune_cache.stats()["memory_hits"] == 1
    _same_lists(got.to_list(), again.to_list())


def test_autotune_probes_the_callers_frame_layout():
    _, tcfg = _configs("default")
    sess = DetectionSession(SVM, tcfg, device="cpu")
    gray = np.stack([f.mean(-1).astype(np.float32)
                     for f in _frames((160, 128), 2)])
    sess.detect_batch(gray)
    assert list(tdet.autotune_report()) == [
        "160x128->160x128 B=2 mesh=data:1 [gray-float32] on cpu"]


def test_cache_path_resolution(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    assert autotune_cache.cache_path().endswith(
        str(pathlib.Path(".cache") / "repro_torch" / "autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "")
    assert autotune_cache.cache_path() is None          # disabled
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    assert autotune_cache.cache_path() == str(tmp_path / "c.json")


def test_cache_store_lookup_and_corruption(monkeypatch, tmp_path):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    autotune_cache.store("k1", 4, {1: 9.5, 4: 3.25})
    got = autotune_cache.lookup("k1")
    assert got == {"chunk": 4, "probe_ms": {1: 9.5, 4: 3.25}}
    assert autotune_cache.lookup("other") is None
    assert set(json.loads(path.read_text())) == {
        autotune_cache.host_fingerprint()}
    path.write_text("{not json")
    autotune_cache._reset_for_tests()
    assert autotune_cache.lookup("k1") is None
    assert autotune_cache.stats()["load_errors"] == 1
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "")
    autotune_cache.store("k2", 1, {1: 2.0})
    assert autotune_cache.stats()["writes"] == 0


def test_disk_cache_round_trips_a_probed_schedule(monkeypatch, tmp_path):
    """A schedule probed by one process is restored from disk by the next
    (memory cleared) without a probe."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    _, tcfg = _configs("quant")
    frames = _frames((160, 128), 3, seed=4)
    first = DetectionSession(SVM, tcfg, device="cpu").detect_batch(frames)
    (entry,) = tdet.autotune_report().values()
    assert entry["source"] == "probe"
    tdet._AUTOTUNE.clear()
    autotune_cache._reset_for_tests()
    second = DetectionSession(SVM, tcfg, device="cpu").detect_batch(frames)
    (restored,) = tdet.autotune_report().values()
    assert restored["source"] == "disk"
    assert restored["chunk"] == entry["chunk"]
    assert autotune_cache.stats()["probes"] == 0
    assert autotune_cache.stats()["disk_hits"] == 1
    _same_lists(first.to_list(), second.to_list())
