"""The port's metrics export (repro_torch/obs/metrics.py, a copy of
repro/obs/metrics.py) and the events its DetectionService emits,
against the JAX reference (tests/test_metrics.py is the reference's
suite).

  * SINKS: the reference suite's unit contract on the port's copy --
    JSONL round trip (numpy payloads and torch tensors of any dtype
    included), ring bounds and counts, callback/tee fan-out, the
    Emitter's stamping and error swallowing, MetricsConfig wiring
    through the port's PipelineConfig JSON -- and each sink writing what
    the reference's writes for the same events.
  * ENGINE (CPU, device="cpu"): for one run submitted one frame at a
    time -- a deadline shed, a killed worker, stage timing on -- the
    port's service emits the same event kinds in the same order as the
    reference's, with the same fields and the same values wherever they
    do not measure time, the host's pace or the platform; plus the
    reference suite's lifecycle, disabled-default, chaos and stage-timing
    cases, the chaos run's latency fault and ladder thresholds derived
    from the measured per-frame ms. Every wait is bounded.
"""
import dataclasses
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.detector import DetectorConfig as JDetectorConfig
from repro.obs import metrics as jmetrics
from repro.serve.engine import DetectionService as JDetectionService
from repro.serve.faults import FaultInjector as JFaultInjector
from repro.serve.faults import FaultSpec as JFaultSpec
from repro_torch.core.detector import DetectorConfig, FrameDetector
from repro_torch.obs.metrics import (CallbackSink, Emitter, JsonlSink,
                                     MetricsConfig, MetricsSink, NullSink,
                                     RingSink, TeeSink, make_sink)
from repro_torch.serve.engine import DetectionService
from repro_torch.serve.faults import FaultInjector, FaultSpec
from repro_torch.serve.resilience import ResilienceConfig

RNG = np.random.default_rng(11)
W = RNG.normal(size=3780).astype(np.float32) * .01
SVM = {"w": W, "b": np.float32(0.0)}
DET_CFG = DetectorConfig(score_threshold=-10.0, scales=(1.0,))

#: every event kind the engine can emit (metrics.py module docstring)
KNOWN_KINDS = {"service_start", "batch", "rung_transition",
               "deadline_shed", "worker_failure", "restart",
               "service_stop", "stage_timing"}
#: payload fields that measure time, depend on the host's pace (the
#: queue depth is read after the answers, while the client may already
#: have submitted its next frame) or describe the platform
TIMED = {"seq", "t_ms", "ms_per_frame", "latency_ms", "queue_ms_mean",
         "queue_ms_max", "compute_ms_per_frame", "queue_depth",
         "platform"}


def _frames(n, h=160, w=128, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for _ in range(n)]


def _service(**kw):
    kw.setdefault("detector", DET_CFG)
    kw.setdefault("frame_batch", 1)
    kw.setdefault("max_wait_ms", 1.0)
    kw.setdefault("device", "cpu")
    return DetectionService(SVM, **kw)


def _assert_stamped(events):
    """Stamped fields present, seq unique and gapless, t_ms non-negative,
    kind known (file order is not asserted: the write happens outside
    the emitter's lock)."""
    assert events, "no events emitted"
    seqs = sorted(e["seq"] for e in events)
    assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))
    assert all(e["t_ms"] >= 0 for e in events)
    assert {e["kind"] for e in events} <= KNOWN_KINDS


# ================================================================ sinks

def test_jsonl_round_trip_and_same_bytes_as_reference(tmp_path):
    sent = [{"kind": "service_start", "seq": 0, "t_ms": 0.0,
             "devices": 4, "rungs": ["full", "reduced"]},
            {"kind": "batch", "seq": 1, "t_ms": 1.5, "n": 2,
             "ms_per_frame": 1.5, "queue_depth": 0,
             "lat": np.float32(1.5), "occ": np.asarray([0.5, 1.0])},
            {"kind": "service_stop", "seq": 2, "t_ms": 3.0, "frames": 2}]
    paths = []
    for mod in (None, jmetrics):
        path = tmp_path / f"{'j' if mod else 't'}.jsonl"
        sink = (JsonlSink if mod is None else mod.JsonlSink)(str(path))
        for ev in sent:
            sink.emit(ev)
        sink.close()
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    back = JsonlSink.read(str(paths[0]))
    _assert_stamped(back)
    assert back[1]["lat"] == 1.5 and back[1]["occ"] == [0.5, 1.0]
    assert [e["kind"] for e in back] == [e["kind"] for e in sent]
    for line in paths[0].read_text().splitlines():
        json.loads(line)                    # each line valid on its own


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.bool])
def test_jsonl_torch_tensor_payloads_stay_valid(tmp_path, dtype):
    """A tensor that reaches a payload keeps the stream valid JSON: a
    0-d tensor becomes its number, a larger one a nested list."""
    path = str(tmp_path / "t.jsonl")
    sink = JsonlSink(path)
    scalar = torch.tensor(3, dtype=dtype)
    sink.emit({"kind": "batch", "seq": 0, "t_ms": 0.0, "x": scalar,
               "v": torch.ones(2, 2, dtype=dtype)})
    sink.close()
    (ev,) = JsonlSink.read(path)
    assert ev["x"] == scalar.item() and not isinstance(ev["x"], (list, str))
    assert ev["v"] == torch.ones(2, 2, dtype=dtype).tolist()


def test_jsonl_append_and_close_idempotent(tmp_path):
    path = str(tmp_path / "a.jsonl")
    s1 = JsonlSink(path)
    s1.emit({"kind": "batch", "seq": 0, "t_ms": 0.0})
    s1.close()
    s1.close()
    s1.emit({"kind": "batch", "seq": 9, "t_ms": 0.0})   # after close: dropped
    s2 = JsonlSink(path)
    s2.emit({"kind": "batch", "seq": 1, "t_ms": 0.0})
    s2.close()
    assert [e["seq"] for e in JsonlSink.read(path)] == [0, 1]


def test_ring_sink_bounds_and_counts_as_reference():
    ours, ref = RingSink(capacity=3), jmetrics.RingSink(capacity=3)
    for i in range(5):
        ev = {"kind": "batch" if i % 2 else "restart", "seq": i}
        ours.emit(ev)
        ref.emit(ev)
    assert ours.events() == ref.events() and len(ours.events()) == 3
    assert ours.counts() == ref.counts() == {"restart": 2, "batch": 1}
    assert [e["seq"] for e in ours.events(kind="batch")] == [3]


def test_callback_tee_and_protocol():
    got = []
    ring = RingSink(8)
    tee = TeeSink([CallbackSink(got.append), ring])
    tee.emit({"kind": "batch", "seq": 0})
    tee.close()
    assert got == ring.events() == [{"kind": "batch", "seq": 0}]
    for sink in (NullSink(), RingSink(1), CallbackSink(lambda e: None),
                 TeeSink([]), JsonlSink.__new__(JsonlSink)):
        assert isinstance(sink, MetricsSink)


def test_emitter_stamps_and_swallows_sink_errors():
    class Boom:
        def emit(self, event):
            raise OSError("disk full")

        def close(self):
            raise OSError("still full")

    em = Emitter(Boom(), rank0_only=False)
    em.emit("batch", n=1)
    em.emit("batch", n=2)
    assert em.dropped == 2 and "disk full" in em.last_error
    em.close()

    ring = RingSink(8)
    em = Emitter(ring, rank0_only=False)
    em.emit("batch", n=1)
    time.sleep(0.002)
    em.emit("restart", restarts=1)
    _assert_stamped(ring.events())
    assert ring.events()[1]["t_ms"] >= ring.events()[0]["t_ms"]
    assert not Emitter(NullSink(), rank0_only=False).active


def test_emitter_rank_guard_uses_the_port_platform(monkeypatch):
    """rank0_only asks repro_torch.platform.is_main(): True without a
    process group, and only rank 0 emits when one is up."""
    import torch.distributed as dist
    from repro_torch import platform
    assert platform.is_main() is True
    assert Emitter(RingSink(4)).active
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert platform.is_main() is False
    em = Emitter(RingSink(4))
    assert not em.active and Emitter(RingSink(4), rank0_only=False).active


def test_emitter_thread_safe_seq():
    ring = RingSink(4096)
    em = Emitter(ring, rank0_only=False)

    def pump():
        for _ in range(200):
            em.emit("batch", n=1)

    ts = [threading.Thread(target=pump) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(e["seq"] for e in ring.events()) == list(range(800))


def test_metrics_config_and_make_sink_as_reference(tmp_path):
    assert dataclasses.asdict(MetricsConfig()) == \
        dataclasses.asdict(jmetrics.MetricsConfig())
    assert not MetricsConfig().enabled
    sink, ring = make_sink(MetricsConfig())
    assert isinstance(sink, NullSink) and ring is None
    cfg = MetricsConfig(jsonl_path=str(tmp_path / "m.jsonl"), ring=16)
    assert cfg.enabled
    sink, ring = make_sink(cfg)
    assert isinstance(sink, TeeSink) and isinstance(ring, RingSink)
    sink.emit({"kind": "batch", "seq": 0, "t_ms": 0.0})
    sink.close()
    assert ring.counts() == {"batch": 1}
    assert len(JsonlSink.read(cfg.jsonl_path)) == 1
    sink, ring = make_sink(MetricsConfig(ring=8))
    assert isinstance(sink, RingSink) and sink is ring


def test_pipeline_config_metrics_round_trip(tmp_path):
    from repro_torch.api import PipelineConfig
    mc = MetricsConfig(jsonl_path=str(tmp_path / "m.jsonl"), ring=32,
                       stage_timing=True)
    cfg = PipelineConfig()
    cfg = cfg.replace(service=dataclasses.replace(cfg.service, metrics=mc))
    back = PipelineConfig.from_dict(json.loads(cfg.to_json()))
    assert back.service.metrics == mc and back == cfg


# =============================================================== engine

def _scripted_run(make_service, inject, frames):
    """One run submitted one frame at a time: frame 0, then a request
    whose budget is already spent (shed), then the rest; the injector
    kills the worker at frame batch 2. Returns the ring's events."""
    svc = make_service(inject)
    svc.start()
    try:
        svc.submit_frame(frames[0]).get(timeout=120)
        shed = svc.submit_frame(frames[1], deadline_ms=1e-6).get(timeout=60)
        assert shed.get("deadline_exceeded") is True
        for f in frames[1:]:
            r = svc.submit_frame(f).get(timeout=120)
            assert "error" not in r
    finally:
        svc.stop()
    return svc._metrics_ring.events()


def test_engine_events_match_reference_in_order_and_fields():
    frames = _frames(5)
    metrics = dict(ring=256, stage_timing=True)
    ours = _scripted_run(
        lambda inj: _service(metrics=MetricsConfig(**metrics), faults=inj),
        FaultInjector((FaultSpec("kill_worker", at_batches=(2,)),)),
        frames)
    jsvm = {"w": jnp.asarray(W), "b": jnp.float32(0.0)}
    ref = _scripted_run(
        lambda inj: JDetectionService(
            jsvm, detector=JDetectorConfig(score_threshold=-10.0,
                                           scales=(1.0,)),
            frame_batch=1, max_wait_ms=1.0, faults=inj,
            metrics=jmetrics.MetricsConfig(**metrics)),
        JFaultInjector((JFaultSpec("kill_worker", at_batches=(2,)),)),
        frames)
    _assert_stamped(ours)
    kinds = [e["kind"] for e in ours]
    assert kinds == [e["kind"] for e in ref]
    assert {"service_start", "batch", "stage_timing", "deadline_shed",
            "worker_failure", "restart", "service_stop"} == set(kinds)
    assert kinds[0] == "service_start" and kinds[-1] == "service_stop"
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b), a["kind"]
        assert {k: v for k, v in a.items() if k not in TIMED} == \
            {k: v for k, v in b.items() if k not in TIMED}, a["kind"]
        if "latency_ms" in a:
            assert sorted(a["latency_ms"]) == sorted(b["latency_ms"])
    assert ours[0]["platform"]["backend"] == "cpu"


def test_engine_emits_lifecycle_and_batches(tmp_path):
    path = str(tmp_path / "serve.jsonl")
    svc = _service(metrics=MetricsConfig(jsonl_path=path, ring=64))
    svc.start()
    try:
        for r in svc.detect_frames(_frames(4), timeout=120):
            assert "detections" in r
    finally:
        svc.stop()
    events = JsonlSink.read(path)
    _assert_stamped(events)
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "service_start" and kinds[-1] == "service_stop"
    batches = [e for e in events if e["kind"] == "batch"]
    assert sum(b["n"] for b in batches) == 4
    for b in batches:
        assert b["ms_per_frame"] > 0 and b["latency_ms"]["p99"] >= 0
        assert 0 < b["occupancy"] <= 1.0 and isinstance(b["rung"], str)
    assert events[-1]["frames"] == 4
    m = svc.stats["metrics"]
    assert m["enabled"] and m["dropped"] == 0
    assert m["emitted"] == len(events)
    assert m["recent"]["batch"] == len(batches)


def test_metrics_disabled_is_default():
    svc = _service()
    svc.start()
    try:
        svc.detect_frames(_frames(2), timeout=120)
    finally:
        svc.stop()
    assert svc.stats["metrics"] == {"enabled": False, "emitted": 0,
                                    "dropped": 0}


def test_chaos_run_emits_transition_restart_and_shed(tmp_path):
    """A chaos run with the JSONL sink emits events for rung
    transitions, the worker restart and the deadline sheds, and the
    stream re-parses clean. The latency fault and the ladder's lines
    scale with the measured per-frame ms."""
    det = FrameDetector(SVM, DET_CFG, device="cpu")
    frames = _frames(14)
    det(frames[0])
    t0 = time.perf_counter()
    for f in frames[:4]:
        det(f)
    spike = max(60.0, 20.0 * (time.perf_counter() - t0) * 1e3 / 4)
    path = str(tmp_path / "chaos.jsonl")
    inj = FaultInjector([
        FaultSpec("latency", at_batches=(2, 3, 4, 5), latency_ms=spike),
        FaultSpec("kill_worker", at_batches=(8,)),
    ], seed=0)
    svc = _service(
        metrics=MetricsConfig(jsonl_path=path, ring=64), faults=inj,
        resilience=ResilienceConfig(degrade_p99_ms=spike * 0.6,
                                    recover_p99_ms=spike * 0.3,
                                    recover_dwell=2, latency_window=4))
    shed_futs = [svc.submit_frame(f, deadline_ms=1.0) for f in frames[:2]]
    time.sleep(0.05)
    svc.start()
    try:
        for f in frames:
            svc.submit_frame(f).get(timeout=120)
    finally:
        svc.stop()
    for fut in shed_futs:
        assert fut.get(timeout=5).get("deadline_exceeded")

    events = JsonlSink.read(path)
    _assert_stamped(events)
    counts = {}
    for e in events:
        counts[e["kind"]] = counts.get(e["kind"], 0) + 1
    for kind in ("deadline_shed", "rung_transition", "worker_failure",
                 "restart"):
        assert counts.get(kind, 0) >= 1, (kind, counts)
    trans = [e for e in events if e["kind"] == "rung_transition"]
    assert any(t["direction"] == "degrade" for t in trans)
    for t in trans:
        assert t["rung_from"] != t["rung_to"]
        assert t["direction"] in ("degrade", "recover")
    assert [e for e in events if e["kind"] == "deadline_shed"][-1][
        "shed_total"] >= 2
    fail = [e for e in events if e["kind"] == "worker_failure"][0]
    assert "error" in fail and "breaker" in fail
    stop = [e for e in events if e["kind"] == "service_stop"][0]
    assert stop["restarts"] >= 1 and stop["deadline_shed"] >= 2


def test_stage_timing_events_opt_in(tmp_path):
    path = str(tmp_path / "stage.jsonl")
    svc = _service(metrics=MetricsConfig(jsonl_path=path,
                                         stage_timing=True))
    svc.start()
    try:
        svc.detect_frames(_frames(3), timeout=120)
    finally:
        svc.stop()
    stages = [e for e in JsonlSink.read(path) if e["kind"] == "stage_timing"]
    assert stages, "stage_timing=True emitted no stage events"
    for e in stages:
        assert e["queue_ms_mean"] >= 0 and e["compute_ms_per_frame"] > 0
