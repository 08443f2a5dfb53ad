"""The port's DetectionService, session.serve and the serve CLI against
the JAX reference (repro/serve/engine.py, repro/api/session.py:serve,
repro/launch/serve.py), on the CPU: the port runs its plain versions,
the reference its Pallas kernels in interpret mode.

Both services are built by ``session.serve()`` from one configuration
(the reference's ``to_dict()`` carried over) and the golden SVM weights,
and get the same requests: seeded synthetic frames of two shape buckets
(192x128 and 224x160, so the microbatcher parks one bucket while it
serves the other), a malformed frame of each of
``serve/faults.py:malformed_frame``'s four kinds, and 70 seeded windows
(a full window batch of 64, then a padded one). Frames are coalesced up
to ``frame_batch`` 4, however the timing groups them.

Compared: the kept boxes exactly and their scores within the session
tolerances (tests/test_torch_session.py: f32 1e-4; quant 2e-3, one int8
code step moving a score by at most 6.4e-4 with the golden weights);
window scores within the window tolerances (tests/test_torch_window.py:
f32 1e-4, quant 2e-3) and ``human`` equal wherever |score| is beyond
them -- for quant against the reference's eager classify_windows, which
the port's fixed chain follows, since its jitted one moves codes
against it (ROADMAP queue 3); and an ``error`` on exactly the frames
where the reference's answer has one. Each service's frames also equal
its own session's single-frame detect exactly.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import DetectionSession as JSession
from repro.api import presets as j_presets
from repro.core import cascade as jcascade
from repro.core.detector import FrameDetector as JFrameDetector
from repro.core.pipeline import classify_windows as j_classify
from repro_torch.api import (DetectionSession, PipelineConfig,
                             ServiceConfig, presets, register_preset)
from repro_torch.convert import config_from_reference_dict
from repro_torch.core.cascade import reduced_detector
from repro_torch.core.detector import FrameDetector
from repro_torch.data.synth_pedestrian import make_scene, make_windows
from repro_torch.data.synth_pedestrian import PedestrianDataConfig
from repro_torch.obs.metrics import MetricsConfig
from repro_torch.serve.engine import DetectionService
from repro_torch.serve.faults import malformed_frame
from repro_torch.serve.resilience import ResilienceConfig, RetryPolicy

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = dict(np.load(ROOT / "tests" / "golden" / "hog_golden.npz"))
SVM = {"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]}
J_SVM = {"w": jnp.asarray(GOLDEN["svm_w"]), "b": jnp.asarray(GOLDEN["svm_b"])}
THRESHOLD = 0.1          # keeps a few boxes per frame (test_torch_session)
# seeds of malformed_frame's four kinds: rank 1, empty, rank 4, tiny f64
MALFORMED_SEEDS = (11, 1, 4, 0)
# (preset, backend override, frame score tol, window score tol)
CASES = [
    ("default", None, 1e-4, 1e-4),
    ("paper", "kernel", 1e-4, 1e-4),
    ("quant", None, 2e-3, 2e-3),
]


def _configs(preset, backend):
    """The preset at THRESHOLD (and the backend override) for both
    packages. Batches run as one wide step (batch_chunk above any batch
    the microbatcher forms): the autotune's probes of every batch size
    would take most of the CPU time, and tests/test_torch_batch.py holds
    the schedules to the reference."""
    ref = j_presets(preset)
    det = dataclasses.replace(ref.detector, score_threshold=THRESHOLD,
                              batch_chunk=1 << 10,
                              **({"backend": backend} if backend else {}))
    ref = ref.replace(detector=det)
    return ref, config_from_reference_dict(ref.to_dict())


def _requests():
    frames = [make_scene(np.random.default_rng(s), *hw, n_people=1)[0]
              for s, hw in enumerate([(192, 128)] * 3 + [(224, 160)] * 2
                                     + [(192, 128)] * 2)]
    bad = [malformed_frame(np.random.default_rng(s))
           for s in MALFORMED_SEEDS]
    mixed = frames[:2] + [bad[0]] + frames[2:4] + bad[1:3] + frames[4:] \
        + [bad[3]]
    wins, _ = make_windows(40, 30, PedestrianDataConfig(),
                           np.random.default_rng(5))
    return mixed, list(wins)


REQUESTS = _requests()


def _serve(session, frames, windows):
    svc = session.serve(frame_batch=4, max_wait_ms=5.0).start()
    try:
        res = svc.detect_frames(frames, timeout=300)
        win = svc.detect(windows, timeout=300)
    finally:
        svc.stop()
    # read after stop(): the worker updates its counters just after it
    # answers, and stop() joins it
    return res, win, dict(svc.stats)


@pytest.mark.parametrize("preset,backend,ftol,wtol", CASES)
def test_service_answers_match_reference_service(preset, backend, ftol,
                                                 wtol):
    jcfg, tcfg = _configs(preset, backend)
    frames, windows = REQUESTS
    jsess = JSession(J_SVM, jcfg)
    tsess = DetectionSession(SVM, tcfg, device="cpu")
    jres, jwin, _ = _serve(jsess, frames, windows)
    tres, twin, stats = _serve(tsess, frames, windows)

    assert len(tres) == len(jres) == len(frames)
    assert ["error" in r for r in tres] == ["error" in r for r in jres]
    # rank 1 and rank 4 have no (H, W[, 3]) shape; the empty and the
    # tiny f64 frame run (and keep no box)
    assert sum("error" in r for r in tres) == 2
    n_boxes = 0
    for i, (t, j) in enumerate(zip(tres, jres)):
        if "error" in t:
            assert t["detections"] == [] == j["detections"]
            continue
        assert [d["box"] for d in t["detections"]] == \
            [d["box"] for d in j["detections"]], f"frame {i}"
        assert [d["scale"] for d in t["detections"]] == \
            [d["scale"] for d in j["detections"]]
        np.testing.assert_allclose([d["score"] for d in t["detections"]],
                                   [d["score"] for d in j["detections"]],
                                   rtol=0, atol=ftol)
        assert t["saturated"] == j["saturated"]
        assert t["degraded_mode"] == "full"
        # the service equals the session's own single-frame detect
        assert t["detections"] == tsess.detect(frames[i]).to_list()
        n_boxes += len(t["detections"])
    assert n_boxes >= 5, "the comparison is vacuous"

    ts = np.array([w["score"] for w in twin])
    th = np.array([w["human"] for w in twin])
    if jcfg.hog.numerics == "fixed":
        # the jitted reference contracts its grayscale in the fixed chain
        # and moves codes against its own eager chain (up to 3.5e-3 on
        # these 70 windows, ROADMAP queue 3); the port follows the eager
        # one, so the window answers are held to it
        with jax.disable_jit():
            out = j_classify(J_SVM, jnp.asarray(np.stack(windows)),
                             cfg=jcfg.hog, path=jcfg.detector.backend)
        js, jh = np.asarray(out["score"]), np.asarray(out["human"])
    else:
        js = np.array([w["score"] for w in jwin])
        jh = np.array([w["human"] for w in jwin])
    np.testing.assert_allclose(ts, js, rtol=0, atol=wtol)
    sure = np.abs(js) > wtol
    np.testing.assert_array_equal(th[sure], jh[sure])
    assert stats["batches"] == 2 and stats["requests"] == len(windows)
    assert stats["frame_answers"] == len(frames)
    assert stats["frames"] == len(frames) - 2
    assert stats["platform"]["backend"] in ("cpu", "cuda")


def test_malformed_frames_error_where_reference_does():
    """The reference's answer carries ``error`` on a rank-1 and a rank-4
    frame (no (H, W[, 3]) shape); the port's does on the same ones."""
    _, tcfg = _configs("default", None)
    svc = DetectionSession(SVM, tcfg, device="cpu").serve(
        frame_batch=4).start()
    bad = [malformed_frame(np.random.default_rng(s))
           for s in MALFORMED_SEEDS]
    res = svc.detect_frames(bad, timeout=60)
    svc.stop()
    assert ["error" in r for r in res] == [True, False, True, False]
    assert all(r["detections"] == [] for r in res)


def test_reduced_detector_matches_reference():
    """The "reduced" rung: the same head on the first scale only; its
    boxes are the reference's reduced detector's."""
    jcfg, tcfg = _configs("paper", None)
    frame = make_scene(np.random.default_rng(3), 224, 160, n_people=1)[0]
    det = FrameDetector(SVM, tcfg.detector, device="cpu")
    red = reduced_detector(det)
    jred = jcascade.reduced_detector(JFrameDetector(J_SVM, jcfg.detector))
    assert red.cfg.scales == jred.cfg.scales == (1.0,)
    assert red.device == det.device and red.svm["w"] is det.svm["w"]
    got, want = red(frame), jred.detect_raw(frame).to_list()
    assert [d["box"] for d in got] == [d["box"] for d in want]
    np.testing.assert_allclose([d["score"] for d in got],
                               [d["score"] for d in want], rtol=0,
                               atol=1e-4)
    assert len(reduced_detector(det, 2).cfg.scales) == 2


def test_session_serve_wiring():
    _, tcfg = _configs("paper", "kernel")
    sc = ServiceConfig(window_batch=16, max_wait_ms=3.0, frame_batch=2,
                       max_pending_frames=7,
                       resilience=ResilienceConfig(deadline_ms=250.0),
                       metrics=MetricsConfig(ring=8))
    sess = DetectionSession(SVM, tcfg.replace(service=sc), device="cpu")
    svc = sess.serve()
    assert svc._detector is sess.detector and svc.device == sess.device
    assert (svc.batch, svc.max_wait, svc.frame_batch,
            svc.max_pending_frames) == (16, 0.003, 2, 7)
    assert svc.res.deadline_ms == 250.0 and svc._emit.active
    assert svc.path == "kernel" and svc.cfg == tcfg.hog
    assert svc._ladder.rungs == ("full", "reduced")
    assert svc._reduced.cfg.scales == (1.0,)
    assert svc.stats["platform"]["torch_version"]
    # overrides: any engine kwarg; a detector override builds its own
    own = sess.serve(detector=dataclasses.replace(tcfg.detector,
                                                  scales=(1.0,)),
                     frame_batch=5)
    assert own._detector is not sess.detector and own.frame_batch == 5
    assert own.device == sess.device
    with pytest.raises(NotImplementedError, match="cascade"):
        sess.serve(cascade=object())
    cascade = config_from_reference_dict(j_presets("cascade").to_dict())
    with pytest.raises(NotImplementedError, match="cascade"):
        DetectionSession(SVM, cascade, device="cpu").serve()
    assert DetectionService(SVM, frame_detector=sess.detector,
                            device="cpu")._detector is sess.detector


@pytest.mark.parametrize("name", ["default", "paper", "faithful", "perf",
                                  "quant", "sharded", "uhd", "cascade",
                                  "resilient"])
def test_every_reference_preset_round_trips(name):
    """Every reference preset, resilient's service knobs and cascade's
    dict included, loads into the port's typed tree and dumps back
    equal; ServiceConfig and its nested configs come back typed."""
    import json
    ref = j_presets(name).to_dict()
    cfg = PipelineConfig.from_dict(ref)
    assert cfg.to_dict() == ref
    assert isinstance(cfg.service, ServiceConfig)
    assert isinstance(cfg.service.resilience, ResilienceConfig)
    assert isinstance(cfg.service.resilience.retry, RetryPolicy)
    assert isinstance(cfg.service.metrics, MetricsConfig)
    assert PipelineConfig.from_dict(json.loads(cfg.to_json())) == cfg
    if name == "resilient":
        assert cfg.service.resilience.deadline_ms == 500.0
        assert cfg.service.resilience.degrade_p99_ms == 120.0
        assert cfg.cascade["enabled"] is True


def test_register_preset():
    cfg = presets("paper").replace(name="site-a")
    assert register_preset("site-a", cfg) is cfg
    assert presets("site-a") is cfg and "site-a" in presets()


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT, env=env)


def test_serve_cli_detect_chaos_and_metrics(tmp_path):
    path = tmp_path / "m.jsonl"
    out = _cli("--detect", "--frames", "2", "--chaos", "--device", "cpu",
               "--metrics", str(path))
    assert out.returncode == 0, out.stderr
    assert "all_resolved=True" in out.stdout
    assert "service stats frames=2" in out.stdout
    assert "torch=" in out.stdout and "metrics " in out.stdout
    assert path.exists()


def test_serve_cli_lm_dense_runs_and_other_families_raise():
    out = _cli("--arch", "qwen3-14b", "--device", "cpu", "--new-tokens",
               "4")
    assert out.returncode == 0, out.stderr
    assert "arch=qwen3-14b" in out.stdout and "out=(4, 20)" in out.stdout
    out = _cli("--arch", "mamba2-130m", "--device", "cpu")
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr and "ssm" in out.stderr
