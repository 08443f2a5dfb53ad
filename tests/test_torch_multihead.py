"""Multi-head (stacked-classifier) detection in the port, against its own
single-head path and against the JAX reference (tests/test_multihead.py's
cases, on the CPU: the port's plain versions, the reference's Pallas
kernels in interpret mode).

K heads score in one widened (BH*BW, 36) @ (36, 105*K) product. Head k's
plane must equal head k scored alone: exactly in the fixed (int8) mode,
whose codes are per column and whose sums are exact; in the float modes
within the f32 summation-order tolerance, since torch.matmul on the CPU
may block a wider product differently (as XLA does in the reference's own
float cases). On the card the widened kernel launches one CTA grid per
head on the one-head body, so there each head's plane is bit for bit its
one-head plane (chip_smoke.py's multihead phase). Then: K = 1 equal to
the single-head program, batches equal to single frames, per-class NMS
isolated, the class axis of Detections, the registry and its heads.json
shared byte for byte by both packages, session class subsets, and the
port's K = 3 boxes equal to the reference's.
"""
import dataclasses
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DetectionSession as JSession
from repro.api import presets as j_presets
from repro.core.detector import nms_keep as j_nms_keep
from repro.core.heads import HeadRegistry as JRegistry
from repro_torch.api import DetectionSession, PipelineConfig
from repro_torch.api.results import Detections
from repro_torch.convert import config_from_reference_dict, \
    registry_from_numpy
from repro_torch.core.detector import (DecodeTables, DetectorConfig,
                                       FrameDetector, nms_keep)
from repro_torch.core.heads import HeadRegistry
from repro_torch.core.hog import HOGConfig
from repro_torch.core.video import Tracker
from repro_torch.data.synth_pedestrian import make_scene

SEED = 7
GOLDEN = dict(np.load(pathlib.Path(__file__).parent / "golden"
                      / "hog_golden.npz"))
#: float planes of a widened product against one head's: f32 summation
#: order of 36-term dot products
FLOAT_TOL = 1e-5


def _mk_heads(n, f, rng):
    return [{"w": rng.normal(0, 0.05, (f,)).astype(np.float32),
             "b": np.float32(rng.normal() * 0.01)} for _ in range(n)]


def _stack(heads):
    return {"w": np.stack([h["w"] for h in heads]),
            "b": np.asarray([h["b"] for h in heads], np.float32)}


def _frame(rng, h=200, w=160):
    return rng.integers(0, 255, (h, w, 3), np.uint8)


def _raw(det):
    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return tuple(host(x) for x in (det._scores, det._index, det._keep,
                                   det._n_valid))


#: (numerics, descriptor dtype, backend): each numerics mode once, on the
#: backends its presets run (paper+kernel, perf, quant)
MODES = [("float", "f32", "kernel"), ("float", "bf16", "fused"),
         ("fixed", "f32", "fused")]
#: two pyramid levels (192x128, 153x102) of a small frame
HW = (192, 128)


def _same(got, want, numerics):
    s, i, kp, nv = got
    s1, i1, kp1, nv1 = want
    if numerics == "fixed":
        assert np.array_equal(s, s1)
    else:
        np.testing.assert_allclose(s, s1, rtol=0, atol=FLOAT_TOL)
    assert np.array_equal(i, i1) and np.array_equal(kp, kp1)
    assert np.array_equal(nv, nv1)


@pytest.fixture(scope="module")
def per_mode():
    """Per mode: a frame, two heads, the stacked detector's result and
    each head's single-head result (built once; the CPU runs the plain
    versions)."""
    out = {}
    for numerics, feat, backend in MODES:
        rng = np.random.default_rng(SEED)
        hog = HOGConfig(numerics=numerics, feat_dtype=feat)
        cfg = DetectorConfig(hog=hog, score_threshold=-3.0, backend=backend)
        frame = _frame(rng, *HW)
        heads = _mk_heads(2, hog.n_features, rng)
        multi = FrameDetector(_stack(heads), cfg, "cpu")
        singles = [FrameDetector(h, cfg, "cpu").detect_raw(frame)
                   for h in heads]
        out[numerics, feat] = (cfg, frame, heads, multi,
                               multi.detect_raw(frame), singles)
    return out


@pytest.mark.parametrize("numerics,feat,backend", MODES)
def test_stacked_equal_to_per_head(per_mode, numerics, feat, backend):
    _, _, _, _, multi, singles = per_mode[numerics, feat]
    assert multi.classes == ("head0", "head1")
    for k, single in enumerate(singles):
        _same(_raw(multi.for_class(k)), _raw(single), numerics)


@pytest.mark.parametrize("numerics,feat,backend", MODES)
def test_k1_equal_to_single_head_path(per_mode, numerics, feat, backend):
    """A one-head stack is the single-head detector: the same planes
    exactly (one head of 105 columns: the same product)."""
    cfg, frame, heads, _, _, singles = per_mode[numerics, feat]
    one = FrameDetector(_stack(heads[:1]), cfg, "cpu").detect_raw(frame)
    assert one.classes == ("head0",)
    got, want = _raw(one.for_class(0)), _raw(singles[0])
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("chunk", [1, 8])
def test_batched_multihead_matches_single_frame(per_mode, chunk):
    """Stacked heads on a batch of two frames (frame by frame, and one
    wide step) give each frame its single-frame result."""
    cfg, frame, heads, multi, first, _ = per_mode["float", "f32"]
    det = FrameDetector(_stack(heads), dataclasses.replace(
        cfg, batch_chunk=chunk), "cpu")
    second = np.ascontiguousarray(frame[::-1])
    batch = det.detect_batch_raw([frame, second])
    assert batch.batched and batch.classes == ("head0", "head1")
    assert np.shape(batch.saturated) == (2, 2)
    for i, one in enumerate((first, multi.detect_raw(second))):
        for a, b in zip(_raw(batch.frame(i)), _raw(one)):
            assert np.array_equal(a, b)
    assert batch.frame(0).to_list() == first.to_list()


def test_class_thresholds_gate_each_head(per_mode):
    _, frame, heads, _, _, _ = per_mode["float", "f32"]
    cfg = DetectorConfig(score_threshold=-3.0, class_thresholds=(-3.0, 50.0))
    d = FrameDetector(_stack(heads), cfg, "cpu").detect_raw(frame)
    assert {e["class_id"] for e in d.to_list()} == {0}
    assert int(d.for_class(1)._n_valid) == 0
    bad = dataclasses.replace(cfg, class_thresholds=(0.0,))
    with pytest.raises(ValueError, match="class_thresholds"):
        FrameDetector(_stack(heads), bad, "cpu").detect_raw(frame)


# ---------------------------------------------------- per-class NMS

@pytest.mark.parametrize("seed", range(25))
def test_class_isolation(seed):
    """Identical boxes in two classes: the port's per-class NMS keeps
    both classes' top box, and each class's keep set equals the
    reference's vmapped nms_keep and the class on its own."""
    rng = np.random.default_rng(SEED * 100 + seed)
    n, thr = 12, 0.3
    y0, x0 = rng.uniform(0, 100, n), rng.uniform(0, 100, n)
    boxes = np.stack([y0, x0, y0 + rng.uniform(5, 60, n),
                      x0 + rng.uniform(5, 60, n)], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.1, 5.0, (2, n)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    stacked = np.stack([boxes, boxes])
    keep = nms_keep(torch.from_numpy(stacked), torch.from_numpy(scores),
                    thr).numpy()
    want = np.asarray(jax.vmap(j_nms_keep, in_axes=(0, 0, None))(
        jnp.asarray(stacked), jnp.asarray(scores), thr))
    assert np.array_equal(keep, want)
    for k in range(2):
        alone = nms_keep(torch.from_numpy(boxes),
                         torch.from_numpy(scores[k]), thr).numpy()
        assert np.array_equal(keep[k], alone)
    assert keep[0, 0] and keep[1, 0]


# ------------------------------------------------- Detections class axis

def test_detections_class_axis_api(per_mode):
    cfg, frame, heads, multi, first, _ = per_mode["float", "f32"]
    d = Detections(first._scores, first._index, first._keep,
                   first._n_valid, first._tables,
                   classes=("pedestrian", "vehicle"))
    assert d.classes == ("pedestrian", "vehicle")
    lst = d.to_list()
    assert lst and all({"box", "score", "scale", "class_id",
                        "label"} <= set(e) for e in lst)
    assert {e["label"] for e in lst} <= {"pedestrian", "vehicle"}
    assert all(lst[i]["score"] >= lst[i + 1]["score"]
               for i in range(len(lst) - 1))
    assert list(d.class_ids) == [e["class_id"] for e in lst]
    ped = d.for_class("pedestrian")
    assert ped.classes is None
    assert len(ped.to_list()) == sum(e["class_id"] == 0 for e in lst)
    assert d.for_class(1).to_list() == [
        {k: v for k, v in e.items() if k not in ("class_id", "label")}
        for e in lst if e["class_id"] == 1]
    assert np.shape(d.saturated) == (2,)
    b = Detections.stack([d, d])
    assert b.batched and b.batch_size == 2 and b.classes == d.classes
    s, i, kp, nv = _raw(b.frame(1))
    assert np.array_equal(s, d._scores.numpy()) and np.shape(nv) == (2,)
    assert b.to_list() == [lst, lst]
    assert b.for_class("vehicle").batched
    with pytest.raises(ValueError, match="class names"):
        Detections.stack([d, first])
    with pytest.raises(ValueError, match="single-head"):
        ped.for_class(0)


def test_detections_class_axis_empty():
    t = DecodeTables(np.zeros((0, 4), np.float32),
                     np.zeros((0,), np.float32), 0)
    e = Detections.empty(t, classes=("a", "b"))
    assert e.to_list() == [] and not e.batched and e.classes == ("a", "b")
    assert e.for_class("b").to_list() == []
    eb = Detections.empty_batch(t, 3, classes=("a", "b"))
    assert eb.batched and eb.to_list() == [[], [], []]
    assert eb.frame(2).classes == ("a", "b")
    # a frame smaller than one window, through the detector
    det = FrameDetector(_stack(_mk_heads(2, 3780, np.random.default_rng(0))),
                        device="cpu")
    small = det.detect_raw(np.zeros((40, 30, 3), np.uint8))
    assert small.to_list() == [] and small.classes == ("head0", "head1")
    assert det.detect_batch_raw([np.zeros((40, 30), np.uint8)] * 2) \
        .to_list() == [[], []]


# ----------------------------------------------------------- registry

def test_registry_stacking_and_thresholds():
    rng = np.random.default_rng(SEED + 5)
    f = 3780
    heads = _mk_heads(3, f, rng)
    reg, jreg = HeadRegistry(), JRegistry()
    for r in (reg, jreg):
        r.add("ped", heads[0], threshold=0.5)
        r.add("veh", heads[1])
        r.add("_coarse", heads[2])           # auxiliary: excluded
    assert reg.names == jreg.names == ("ped", "veh")
    svm, names, thr = reg.stacked()
    jsvm, jnames, jthr = jreg.stacked()
    assert svm["w"].shape == (2, f) and svm["b"].shape == (2,)
    assert (names, thr) == (jnames, jthr) == (("ped", "veh"), (0.5, None))
    np.testing.assert_array_equal(svm["w"], jsvm["w"])
    np.testing.assert_array_equal(svm["b"], jsvm["b"])
    _, names2, _ = reg.stacked(("veh", "ped"))
    assert names2 == ("veh", "ped")
    svm3, _, _ = reg.stacked(("_coarse",))
    np.testing.assert_array_equal(svm3["w"][0], heads[2]["w"])
    with pytest.raises(KeyError):
        reg.stacked(("nope",))
    with pytest.raises(ValueError):
        reg.add("ped", heads[0])           # no silent overwrite
    reg.add("_tiny", {"w": np.zeros(756, np.float32), "b": 0.0})
    with pytest.raises(ValueError):
        reg.stacked(("ped", "_tiny"))
    # tensors on any device are snapshotted to host f32
    reg.add("t", {"w": torch.ones(f, dtype=torch.float64),
                  "b": torch.tensor(0.5)})
    assert reg.single("t")["w"].dtype == np.float32
    assert reg.n_features == f and len(reg) == 5


def _manifest(path):
    with open(os.path.join(path, "heads.json"), "rb") as fh:
        return fh.read()


def test_registry_checkpoint_round_trip_both_packages(tmp_path):
    """Each package saves the same bytes of heads.json and loads the
    other's registry directory with every head, threshold and metadata."""
    rng = np.random.default_rng(SEED + 6)
    heads = _mk_heads(2, 3780, rng)
    coarse = {"w": rng.normal(size=756).astype(np.float32), "b": 0.5}
    reg, jreg = HeadRegistry(), JRegistry()
    for r in (reg, jreg):
        r.add("ped", heads[0], threshold=0.25, metadata={"v": 1})
        r.add("_coarse", coarse)
    tp, jp = str(tmp_path / "port"), str(tmp_path / "ref")
    reg.save(tp)
    jreg.save(jp)
    assert _manifest(tp) == _manifest(jp)
    assert HeadRegistry.is_registry_checkpoint(jp)
    for back in (HeadRegistry.load(jp), JRegistry.load(tp)):
        assert back.names == ("ped",) and "_coarse" in back
        assert back.get("ped").threshold == 0.25
        assert back.get("ped").metadata == {"v": 1}
        for n in ("ped", "_coarse"):
            np.testing.assert_array_equal(back.get(n).params["w"],
                                          reg.get(n).params["w"])
            assert float(back.get(n).params["b"]) == \
                float(reg.get(n).params["b"])
    conv = registry_from_numpy(jreg)
    assert conv.names == ("ped",) and "_coarse" in conv
    np.testing.assert_array_equal(conv.get("ped").params["w"], heads[0]["w"])
    assert conv.get("ped").metadata == {"v": 1}


def test_session_class_subsets_and_round_trip(tmp_path):
    rng = np.random.default_rng(SEED + 7)
    cfg = DetectorConfig(score_threshold=-1.0)
    heads = _mk_heads(2, cfg.hog.n_features, rng)
    reg = HeadRegistry()
    reg.add("a", heads[0])
    reg.add("b", heads[1], threshold=50.0)   # gated far above any score
    pcfg = PipelineConfig(hog=cfg.hog, detector=cfg)
    sess = DetectionSession(reg, pcfg, device="cpu")
    frame = _frame(rng, *HW)
    both = sess.detect(frame).to_list()
    assert both and {d["label"] for d in both} == {"a"}
    only_a = sess.detect(frame, classes="a").to_list()
    assert [d["box"] for d in only_a] == \
        [d["box"] for d in both if d["label"] == "a"]
    assert sess._detector_for("a") is sess._detector_for(("a",))
    batch = sess.detect_batch([frame], classes=("b", "a"))
    assert batch.classes == ("b", "a")
    assert [d["box"] for d in batch.to_list()[0]] == \
        [d["box"] for d in only_a]
    single = DetectionSession(heads[0], pcfg, device="cpu")
    with pytest.raises(ValueError):
        single.detect(frame, classes="a")
    p = str(tmp_path / "s")
    sess.save(p)
    back = DetectionSession.load(p, pcfg, device="cpu")
    assert back.registry is not None
    assert back.detect(frame).to_list() == both


def test_multihead_rejects_frame_parallel(monkeypatch):
    """Stacked heads and intra-frame tiling: a frame that would tile over
    fp > 1 devices raises the reference's ValueError
    (repro/core/detector.py:1172 _tiled_for), one frame or a batch; with
    one visible device frame_parallel=0 resolves to 1 and runs."""
    from repro.core.detector import FrameDetector as JFrameDetector
    monkeypatch.setenv("REPRO_TEST_DEVICES", "2")
    cfg = DetectorConfig(score_threshold=-1.0, frame_parallel=0,
                         frame_parallel_min_area=0)
    heads = _mk_heads(2, cfg.hog.n_features, np.random.default_rng(SEED + 8))
    det = FrameDetector(_stack(heads), cfg, "cpu")
    frame = np.zeros((160, 128, 3), np.uint8)
    with pytest.raises(ValueError, match="frame_parallel") as ei:
        det.detect_raw(frame)
    with pytest.raises(ValueError, match="frame_parallel"):
        det.detect_batch([frame, frame])
    # the reference's guard, its tile axis resolved to 2 as here
    import repro.core.detector as jdet
    monkeypatch.setattr(jdet, "_resolve_fp", lambda cfg, dp=None: 2)
    ref = JFrameDetector({"w": jnp.zeros((2, 3780)), "b": jnp.zeros(2)},
                         jdet.DetectorConfig(frame_parallel=0))
    with pytest.raises(ValueError) as ej:
        ref._tiled_for(160, 128)
    assert str(ei.value) == str(ej.value)
    monkeypatch.delenv("REPRO_TEST_DEVICES")
    assert det.frame_devices == 1
    plain = FrameDetector(_stack(heads), dataclasses.replace(
        cfg, frame_parallel=1), "cpu")
    assert det.detect_raw(frame).to_list() == \
        plain.detect_raw(frame).to_list()


# ------------------------------------------------ tracker class gating

def _det(box, score, cid=None, label=None):
    d = {"box": box, "score": score, "scale": 1.0}
    if cid is not None:
        d["class_id"] = cid
        d["label"] = label or f"c{cid}"
    return d


def test_tracker_gates_association_on_class():
    trk = Tracker()
    box = (10.0, 10.0, 140.0, 76.0)
    near = (12.0, 11.0, 142.0, 77.0)
    out0 = trk.update([_det(box, 1.0, 0)])
    out1 = trk.update([_det(near, 1.0, 1)])
    assert out0[0]["track_id"] != out1[0]["track_id"]
    assert out1[0]["class_id"] == 1
    out2 = trk.update([_det(near, 1.0, 0), _det(box, 0.9, 1)])
    by_cls = {d["class_id"]: d for d in out2}
    assert by_cls[0]["track_id"] == out0[0]["track_id"]
    assert by_cls[1]["track_id"] == out1[0]["track_id"]
    assert by_cls[0]["hits"] == 2 and by_cls[1]["hits"] == 2


def test_tracker_classless_behavior_unchanged():
    trk = Tracker()
    t0 = trk.update([_det((10.0, 10.0, 140.0, 76.0), 1.0)])
    t1 = trk.update([_det((12.0, 11.0, 142.0, 77.0), 1.0)])
    assert t0[0]["track_id"] == t1[0]["track_id"]
    assert "class_id" not in t1[0]


# ------------------------------------------- K = 3 against the reference

THRESHOLD = 0.26
#: (preset, backend override, score tolerance): tests/test_torch_session.py
#: limits (f32 summation order; quant: three int8 code steps)
K3_CASES = [("default", None, 1e-4), ("paper", "kernel", 1e-4),
            ("quant", None, 2e-3)]


def _k3_registry():
    rng = np.random.default_rng(SEED + 10)
    jreg = JRegistry()
    jreg.add("person", {"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]})
    for name, h in zip(("rand_a", "rand_b"), _mk_heads(2, 3780, rng)):
        jreg.add(name, h, threshold=0.4)
    return jreg


@pytest.mark.parametrize("preset,backend,tol", K3_CASES)
def test_k3_boxes_equal_the_reference(preset, backend, tol):
    """Three heads -- the golden SVM and two seeded ones, per-head
    thresholds -- in both packages' registry sessions on a seeded scene:
    the same kept boxes with the same class ids and labels, scores within
    the session tolerances, and the same candidate counts."""
    ref = j_presets(preset)
    ref = ref.replace(detector=dataclasses.replace(
        ref.detector, score_threshold=THRESHOLD,
        **({"backend": backend} if backend else {})))
    jreg = _k3_registry()
    jsess = JSession(jreg, ref)
    tsess = DetectionSession(registry_from_numpy(jreg),
                             config_from_reference_dict(ref.to_dict()),
                             device="cpu")
    assert tsess.detector.cfg.class_thresholds == \
        jsess.detector.cfg.class_thresholds == (THRESHOLD, 0.4, 0.4)
    frame, _ = make_scene(np.random.default_rng(SEED + 11), *HW, n_people=1)
    jd, td = jsess.detect(frame), tsess.detect(frame)
    assert td.classes == jd.classes == ("person", "rand_a", "rand_b")
    np.testing.assert_array_equal(td._n_valid.numpy(),
                                  np.asarray(jd._n_valid))
    want, got = jd.to_list(), td.to_list()
    key = (lambda d: (d["class_id"], d["box"]))
    assert sorted(map(key, got)) == sorted(map(key, want))
    assert {d["label"] for d in got} == {d["label"] for d in want}
    by = {key(d): d["score"] for d in want}
    for d in got:
        assert abs(d["score"] - by[key(d)]) <= tol
    assert len({d["class_id"] for d in got}) >= 2
