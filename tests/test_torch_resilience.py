"""The port's resilience primitives and its supervised DetectionService
against the JAX reference (repro/serve/resilience.py, serve/faults.py,
serve/engine.py; tests/test_resilience.py is the reference's suite).

Two families:

  * PRIMITIVES: the port's copies of RetryPolicy, CircuitBreaker,
    RollingLatency, DegradationLadder, FaultInjector, chaos_specs and
    malformed_frame driven through the same seeded inputs as the
    reference's, and required to give the same outputs exactly: delay
    sequences, breaker transitions under one fake clock, percentiles,
    ladder rungs over one observation sequence, the injector's firings
    and the malformed arrays.
  * SERVICE (CPU, device="cpu"): the port's service under the
    reference suite's scenarios -- chaos liveness with results identical
    to the unperturbed run, deadline shed before compute, the breaker's
    trip and recovery, a degradation episode and its recovery, stop
    under chaos, submit after stop, a future that times out -- on the
    reference suite's small frames (160x128, scale 1.0, threshold -10).
    The degradation episode's latency fault and thresholds are derived
    from the measured per-frame ms, and every assertion is on outcomes,
    never on wall-clock margins; every wait is bounded.
"""
import dataclasses
import random
import threading
import time

import numpy as np
import pytest

from repro.serve import faults as jfaults
from repro.serve import resilience as jres
from repro_torch.core.detector import DetectorConfig, FrameDetector
from repro_torch.serve import faults, resilience
from repro_torch.serve.engine import (CircuitOpen, DetectionService,
                                      ServiceOverloaded, ServiceStopped)
from repro_torch.serve.faults import (FaultInjector, FaultSpec,
                                      chaos_specs, malformed_frame)
from repro_torch.serve.resilience import ResilienceConfig, RetryPolicy

RNG = np.random.default_rng(11)
SVM = {"w": RNG.normal(size=3780).astype(np.float32) * .01,
       "b": np.float32(0.0)}
DET_CFG = DetectorConfig(score_threshold=-10.0, scales=(1.0,))


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


# =========================================================== primitives

@pytest.mark.parametrize("kw", [
    dict(backoff_base_ms=5.0, backoff_cap_ms=40.0, jitter=0.0),
    dict(jitter=0.5, seed=7),
    dict(backoff_base_ms=1.0, backoff_cap_ms=2.0, jitter=0.25, seed=3),
])
def test_retry_delays_equal_reference(kw):
    ours, ref = RetryPolicy(**kw), jres.RetryPolicy(**kw)
    attempts = range(1, 9)
    assert [ours.delay_ms(a) for a in attempts] == \
        [ref.delay_ms(a) for a in attempts]
    # the service's seeded backoff stream: one rng, successive attempts
    ra, rb = random.Random(kw.get("seed", 0)), random.Random(
        kw.get("seed", 0))
    assert [ours.delay_ms(a, ra) for a in attempts] == \
        [ref.delay_ms(a, rb) for a in attempts]
    assert dataclasses.asdict(ResilienceConfig(retry=ours)) == \
        dataclasses.asdict(jres.ResilienceConfig(retry=ref))


def _breaker_trace(mod, script):
    t = {"now": 0.0}
    br = mod.CircuitBreaker(max_failures=3, reset_after_s=10.0,
                            clock=lambda: t["now"])
    trace = []
    for op, arg in script:
        if op == "clock":
            t["now"] = arg
        else:
            out = getattr(br, op)()
            trace.append((op, out, br.state, br.consecutive,
                          br.opened_at))
    return trace, br.snapshot()


def test_breaker_transitions_equal_reference_fake_clock():
    rng = np.random.default_rng(5)
    ops = ("record_failure", "record_success", "admit", "probe_due")
    script, now = [], 0.0
    for _ in range(200):
        if rng.random() < 0.2:
            now += float(rng.choice([0.5, 4.0, 10.0]))
            script.append(("clock", now))
        else:
            script.append((ops[int(rng.choice(4, p=[.45, .1, .25, .2]))],
                           None))
    ours, ref = _breaker_trace(resilience, script), \
        _breaker_trace(jres, script)
    assert ours == ref
    states = {s for _, _, s, _, _ in ours[0]}
    assert states == {"closed", "open", "half_open"}   # every state seen


def test_rolling_latency_equal_reference():
    vals = np.random.default_rng(2).exponential(20.0, size=300)
    for window in (1, 4, 64):
        a, b = resilience.RollingLatency(window), jres.RollingLatency(window)
        assert a.percentile(99) == b.percentile(99) == 0.0
        for v in vals:
            a.add(v)
            b.add(v)
            assert (a.percentile(50), a.percentile(99), len(a)) == \
                (b.percentile(50), b.percentile(99), len(b))
        assert a.snapshot() == b.snapshot()


@pytest.mark.parametrize("rungs,kw", [
    (("full", "reduced"), dict(degrade_p99_ms=50.0, recover_p99_ms=20.0,
                               recover_dwell=2)),
    (("full", "cascade", "coarse"), dict(degrade_p99_ms=100.0,
                                         recover_dwell=3, min_samples=1)),
    (("full", "reduced"), dict(degrade_depth=10)),
    (("full", "reduced"), dict()),                          # inert
])
def test_ladder_rungs_equal_reference(rungs, kw):
    rng = np.random.default_rng(9)
    obs = [(float(rng.exponential(40.0)), int(rng.integers(0, 16)),
            int(rng.integers(0, 8))) for _ in range(400)]
    a = resilience.DegradationLadder(rungs, **kw)
    b = jres.DegradationLadder(rungs, **kw)
    assert a.enabled == b.enabled
    assert [a.observe(*o) for o in obs] == [b.observe(*o) for o in obs]
    assert a.snapshot() == b.snapshot()
    if a.enabled:
        assert a.transitions > 0


def _fire(mod, specs, seed, n=60):
    inj = mod.FaultInjector(specs, seed=seed)
    raised = []
    for _ in range(n):
        try:
            inj.before_batch(1)
            raised.append(None)
        except BaseException as e:            # noqa: B036 -- the taxonomy
            raised.append(type(e).__name__)
    return inj.fired, raised, inj.batches


@pytest.mark.parametrize("seed", [0, 42, 5])
def test_fault_injector_fires_as_reference(seed):
    def specs(mod):
        return (mod.FaultSpec("exception", prob=0.3, max_fires=4),
                mod.FaultSpec("exception", prob=0.1, transient=False),
                mod.FaultSpec("kill_worker", prob=0.05, max_fires=2),
                mod.FaultSpec("device_loss", at_batches=(3, 7)),
                mod.FaultSpec("latency", prob=0.2, latency_ms=0.0))
    assert _fire(faults, specs(faults), seed) == \
        _fire(jfaults, specs(jfaults), seed)


def test_chaos_specs_and_taxonomy_equal_reference():
    assert [dataclasses.asdict(s) for s in chaos_specs()] == \
        [dataclasses.asdict(s) for s in jfaults.chaos_specs()]
    assert [t.__name__ for t in faults.DETERMINISTIC_TYPES] == \
        [t.__name__ for t in jfaults.DETERMINISTIC_TYPES]
    assert issubclass(faults.WorkerKilled, BaseException)
    assert not issubclass(faults.WorkerKilled, Exception)
    assert not isinstance(faults.TransientFault("x"),
                          faults.DETERMINISTIC_TYPES)
    assert isinstance(faults.SimulatedDeviceLoss("x"),
                      faults.TransientFault)
    # a refused CUDA launch raises RuntimeError: transient, retried
    assert not isinstance(RuntimeError("cudaError 700"),
                          faults.DETERMINISTIC_TYPES)
    assert issubclass(CircuitOpen, ServiceOverloaded)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("melt_the_chip")


@pytest.mark.parametrize("seed", range(16))
def test_malformed_frame_equals_reference(seed):
    a = malformed_frame(np.random.default_rng(seed))
    b = jfaults.malformed_frame(np.random.default_rng(seed))
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


# ============================================================== service

@pytest.fixture(scope="module")
def serial():
    """Unperturbed per-frame detections, the measured per-frame ms (the
    slowest of three passes after a warm-up), and program warmup for
    everything after it."""
    det = FrameDetector(SVM, DET_CFG, device="cpu")
    frames = _frames(10)
    ref = [det.detect_raw(f).to_list() for f in frames]
    worst = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        for f in frames:
            det.detect_raw(f).to_list()
        worst = max(worst, (time.perf_counter() - t0) * 1e3 / len(frames))
    return frames, ref, worst


def test_chaos_schedule_liveness_and_identical_results(serial):
    frames, ref, _ = serial
    inj = FaultInjector(chaos_specs(), seed=0)
    svc = _service(faults=inj).start()
    res = svc.detect_frames(frames, timeout=120)
    assert [r["detections"] for r in res] == ref
    assert all("error" not in r for r in res)
    assert {k for _, k in inj.fired} == \
        {"kill_worker", "device_loss", "latency"}
    assert svc.stats["restarts"] >= 2 and svc.stats["retries"] >= 2
    assert svc.stats["frame_answers"] == len(frames)
    svc.stop()
    assert not svc._supervisor.is_alive()


def test_deadline_shed_before_compute(serial):
    frames, _, _ = serial
    svc = _service()
    futs = [svc.submit_frame(f, deadline_ms=1.0) for f in frames[:4]]
    time.sleep(0.05)                   # budgets expire while queued
    svc.start()
    for f in futs:
        r = f.get(timeout=30)
        assert r.get("deadline_exceeded") is True
        assert "DeadlineExceeded" in r["error"]
    assert svc.stats["deadline_shed"] == 4
    assert svc.stats["frames"] == 0            # nothing was computed
    ok = svc.submit_frame(frames[0]).get(timeout=60)
    assert "error" not in ok
    svc.stop()


def test_deadline_default_from_config(serial):
    frames, _, _ = serial
    svc = _service(resilience=ResilienceConfig(deadline_ms=1.0))
    fut = svc.submit_frame(frames[0])          # inherits the 1 ms budget
    time.sleep(0.05)
    svc.start()
    assert fut.get(timeout=30).get("deadline_exceeded") is True
    svc.stop()


def test_breaker_trips_to_fail_fast_then_recovers(serial):
    """Two consecutive worker deaths open the breaker: submission raises
    CircuitOpen and queued work is answered, not parked; once the
    cooldown has passed a probe worker serves again and closes it."""
    frames, ref, _ = serial
    inj = FaultInjector((FaultSpec("kill_worker", at_batches=(0, 1),
                                   max_fires=2),), seed=0)
    reset_s = 0.5
    svc = _service(faults=inj,
                   resilience=ResilienceConfig(
                       breaker_failures=2, breaker_reset_s=reset_s,
                       retry=RetryPolicy(max_attempts=5,
                                         backoff_base_ms=1.0,
                                         backoff_cap_ms=2.0))).start()
    fut = svc.submit_frame(frames[0])
    deadline = time.monotonic() + 30
    while svc._breaker.state != "open":
        assert time.monotonic() < deadline, "breaker never opened"
        time.sleep(0.002)
    # open and still cooling: admission fails fast (the breaker's own
    # admit() says whether the cooldown is still running, so a slow host
    # that lets it pass is not mistaken for a failure)
    cooling = not svc._breaker.admit()
    if cooling:
        with pytest.raises(CircuitOpen):
            svc.submit_frame(frames[0])
    r = fut.get(timeout=30)                   # answered, not parked
    assert isinstance(r, dict)
    time.sleep(reset_s + 0.05)                # cooldown over: probe due
    ok = svc.detect_frames([frames[0]], timeout=60)[0]
    assert ok["detections"] == ref[0]
    # the worker records the healthy batch just after it answers (as the
    # reference's engine does), so the close is awaited, bounded
    deadline = time.monotonic() + 10
    while svc.stats["breaker"]["state"] != "closed":
        assert time.monotonic() < deadline, svc.stats["breaker"]
        time.sleep(0.002)
    assert svc.stats["restarts"] >= 2
    svc.stop()


def test_degradation_episode_reports_and_recovers(serial):
    """Latency faults force the reduced rung (reported per response),
    and once they stop the ladder climbs back to full with results
    identical to the unperturbed run. The spike and both thresholds
    scale with the measured per-frame ms, so a slow host moves them
    together; the assertions are on outcomes only."""
    frames, ref, frame_ms = serial
    spike = max(60.0, 20.0 * frame_ms)
    inj = FaultInjector((FaultSpec("latency", at_batches=(2, 3, 4, 5),
                                   latency_ms=spike),), seed=0)
    svc = _service(
        faults=inj,
        resilience=ResilienceConfig(degrade_p99_ms=spike * 0.6,
                                    recover_p99_ms=spike * 0.3,
                                    recover_dwell=2, latency_window=4))
    svc.start()
    rungs = []
    for f in frames:
        r = svc.detect_frames([f], timeout=60)[0]
        rungs.append(r["degraded_mode"])
    assert "reduced" in rungs, f"never degraded: {rungs}"
    assert svc.stats["frames_degraded"] >= 1
    deadline = time.monotonic() + 60
    while svc.stats["degraded_mode"] != "full":
        assert time.monotonic() < deadline, \
            f"never recovered: {svc.stats['ladder']}"
        svc.detect_frames([frames[0]], timeout=60)
    # one at a time, as the thresholds were measured: a queue of ten
    # would raise p99 by itself
    res = [svc.detect_frames([f], timeout=60)[0] for f in frames]
    assert [r["degraded_mode"] for r in res] == ["full"] * len(frames)
    assert [r["detections"] for r in res] == ref
    assert svc.stats["ladder"]["transitions"] >= 2   # down AND back up
    svc.stop()


def test_malformed_frames_do_not_poison_batchmates(serial):
    frames, ref, _ = serial
    rng = np.random.default_rng(3)
    bad = [malformed_frame(rng) for _ in range(4)]
    svc = _service(frame_batch=2).start()
    mixed = [frames[0], bad[0], frames[1], bad[1],
             bad[2], frames[2], bad[3], frames[3]]
    res = svc.detect_frames(mixed, timeout=120)
    assert len(res) == len(mixed)
    assert [res[i]["detections"] for i in (0, 2, 5, 7)] == ref[:4]
    assert svc.stats["frame_answers"] == len(mixed)
    assert svc.stats["restarts"] == 0          # contained, not a death
    svc.stop()
    assert svc._pending_frames == 0


def test_stop_under_chaos_never_hangs_and_stats_reconcile(serial):
    frames, _, _ = serial
    inj = FaultInjector((
        FaultSpec("kill_worker", prob=0.2, max_fires=3),
        FaultSpec("latency", prob=0.5, latency_ms=20.0)), seed=5)
    svc = _service(faults=inj).start()
    futs, lock = [], threading.Lock()

    def client(seed):
        for f in _frames(6, seed=seed):
            try:
                fut = svc.submit_frame(f, deadline_ms=500.0)
            except (ServiceOverloaded, ServiceStopped):
                continue
            with lock:
                futs.append(fut)

    threads = [threading.Thread(target=client, args=(s,))
               for s in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    t0 = time.monotonic()
    svc.stop()
    assert time.monotonic() - t0 < 15
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    for fut in futs:
        assert isinstance(fut.get(timeout=5), dict)   # resolved, somehow
    assert svc._pending_frames == 0
    assert svc.stats["frame_answers"] == len(futs)


def test_submit_after_stop_raises_service_stopped(serial):
    frames, _, _ = serial
    svc = _service().start()
    svc.stop()
    with pytest.raises(ServiceStopped):
        svc.submit_frame(frames[0])
    with pytest.raises(ServiceStopped):
        svc.submit(np.zeros((130, 66, 3), np.uint8))
    with pytest.raises(ServiceStopped):
        svc.detect_frames(frames[:1])


def test_future_timeout_leaves_no_orphan(serial):
    frames, _, _ = serial
    svc = _service()
    fut = svc.submit_frame(frames[0])     # worker not started yet ...
    with pytest.raises(Exception):        # queue.Empty
        fut.get(timeout=0.01)             # ... so the caller times out
    svc.start()                           # service still serves it
    deadline = time.monotonic() + 60
    while svc.stats["frame_answers"] < 1:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    assert svc._pending_frames == 0
    assert svc.stats["frames"] == 1
    assert fut.get(timeout=5)["detections"] is not None
    t0 = time.monotonic()
    svc.stop()
    assert time.monotonic() - t0 < 15


def test_backpressure_rejects_but_recovers(serial):
    frames, _, _ = serial
    svc = _service(max_pending_frames=2)
    futs = [svc.submit_frame(frames[0]), svc.submit_frame(frames[1])]
    with pytest.raises(ServiceOverloaded):
        svc.submit_frame(frames[2])
    assert svc.stats["frame_rejects"] == 1
    soft = svc.detect_frames([frames[2]])[0]          # soft-fails
    assert "ServiceOverloaded" in soft["error"]
    svc.start()
    for fut in futs:
        assert "error" not in fut.get(timeout=60)
    assert "error" not in svc.submit_frame(frames[2]).get(timeout=60)
    svc.stop()


def test_kernel_failure_is_answered_not_served_elsewhere(serial,
                                                       monkeypatch):
    """A RuntimeError from the detector (what a refused CUDA launch
    raises, kernels/build.py:launch) fails its batch; the per-frame rerun
    runs on the SAME detector, and the request is answered with the
    error. Nothing serves it from another path or device, and a window
    batch whose step raises is answered the same way."""
    frames, _, _ = serial
    svc = _service()
    calls = []

    def refused(*a, **k):
        calls.append(1)
        raise RuntimeError("score_matmul: CUDA launch failed with "
                           "cudaError 700")

    monkeypatch.setattr(svc._detector, "detect_raw", refused)
    monkeypatch.setattr(svc._detector, "detect_batch_raw", refused)
    svc.start()
    res = svc.detect_frames(frames[:2], timeout=60)
    for r in res:
        assert "cudaError 700" in r["error"] and r["detections"] == []
    assert svc.stats["frames"] == 0 and len(calls) >= 2
    import repro_torch.serve.engine as engine
    monkeypatch.setattr(engine, "classify_windows", refused)
    w = svc.detect([np.zeros((130, 66, 3), np.uint8)], timeout=60)[0]
    assert "cudaError 700" in w["error"] and w["human"] == -1
    svc.stop()
