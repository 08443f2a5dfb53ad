"""Serving engines of the port -- the port of repro/serve/engine.py.

`DetectionService` -- the paper's co-processor as a batched service:
window requests (RGB windows) are queued, padded to the service's batch
size, classified in one ``classify_windows`` call on the service's
device (the window kernels on the card), results returned per request.
This is the Fig. 6 datapath plus the batching/queueing layer an FPGA
front-end would implement in NIOS/ARM (the paper's "future development"
§VI).

The canonical way to build one is `repro_torch.api.DetectionSession
.serve()`, which wires the service from a single PipelineConfig and
shares the session's per-bucket detection programs (`frame_detector=`
injection).

Full-FRAME requests (`submit_frame` / `detect_frames`) route through the
device-resident multi-scale detector (core/detector.py:FrameDetector):
pyramid, dense HOG, thresholding, top-k and NMS all run on the device,
one program per frame-shape bucket, with per-frame latency/box stats --
the "camera -> detection block" stream the paper sketches in §VI.

Frame requests MICROBATCH: requests whose frames land in the same shape
bucket coalesce (up to `frame_batch` frames, waiting at most
`max_wait_ms` for stragglers) into one batched device step
(`FrameDetector.detect_batch_raw`); requests for other buckets are set
aside and served in arrival order on the next rounds. The bounded frame
queue is the backpressure valve: `submit_frame` raises
`ServiceOverloaded` instead of queueing unbounded work, and a malformed
frame is answered with an error result without poisoning the batch it
arrived in.

RESILIENCE (DESIGN.md §14). Four mechanisms compose on top of the
microbatcher, all configured by `ResilienceConfig` (inert defaults):

  * Deadlines: `submit_frame(frame, deadline_ms=...)` (or the config
    default) gives each request a compute budget; expired requests are
    shed BEFORE compute with a `DeadlineExceeded` payload, so one slow
    batch cannot cascade into a backlog of doomed work.
  * Supervised worker: the detect thread runs under a supervisor that
    respawns it on ANY escape -- including BaseException-grade thread
    death -- with the detector's per-bucket programs intact. In-flight
    requests are retried with capped exponential backoff + jitter when
    the failure looks transient, or failed fast with the original
    traceback when it is deterministic (`faults.DETERMINISTIC_TYPES`).
    A circuit breaker trips to fail-fast admission (`CircuitOpen`)
    after N consecutive failures, half-opens after a cooldown, and
    closes on the first healthy batch.
  * Degradation ladder: rolling p99 latency / queue depth drive a
    hysteresis ladder full -> reduced pyramid scales; every response
    carries `degraded_mode` and `stats` tracks the rung. (The
    reference's full -> cascade -> coarse ladder, wired from a
    CascadeDetector, is a later slice of the port: cascade.)
  * Fault injection: `faults=FaultInjector(...)` (serve/faults.py)
    drives all of the above deterministically in the chaos tests;
    `faults=None` (default) is a no-op.

Futures can never hang: every accepted request is answered exactly once
(result, DeadlineExceeded, or a traceback-carrying error) -- on batch
errors, worker death, breaker trips, and `stop()` with a backlog alike.

`generate` -- LM serving: prefill + greedy/temperature decode loop (port
of repro/serve/engine.py:generate and _sample).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import random
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import platform
from ..core.cascade import reduced_detector
from ..core.detector import (DetectorConfig, FrameDetector, as_svm,
                             resolve_device)
from ..core.hog import HOGConfig, PAPER_HOG
from ..core.pipeline import _same_device, classify_windows
from ..core.svm import SVMParams
from ..models.configs import ModelConfig
from ..models.model import DenseLM, decode_step, prefill
from ..obs.metrics import Emitter, MetricsConfig, make_sink
from .faults import DETERMINISTIC_TYPES, FaultInjector
from .resilience import (CircuitBreaker, DegradationLadder, ResilienceConfig,
                         RollingLatency)

Tensor = torch.Tensor


# ------------------------------------------------------------- detection

@dataclasses.dataclass
class DetectionRequest:
    window: np.ndarray                  # (130, 66, 3) uint8
    future: "queue.Queue"


@dataclasses.dataclass
class FrameRequest:
    frame: np.ndarray                   # (H, W, 3) uint8 or (H, W) gray
    future: "queue.Queue"
    deadline: Optional[float] = None    # absolute time.monotonic() budget
    t_submit: float = 0.0               # for sojourn-latency telemetry
    attempts: int = 0                   # serve attempts consumed so far
    answered: bool = False              # exactly-once answer guard


class ServiceOverloaded(RuntimeError):
    """Raised by submit_frame when the bounded frame queue is full --
    the caller must shed load or retry later (backpressure)."""


class CircuitOpen(ServiceOverloaded):
    """Raised by submit/submit_frame while the circuit breaker is open:
    N consecutive worker failures tripped admission to fail-fast; the
    breaker half-opens after `breaker_reset_s` (see .worker_error)."""


class ServiceStopped(RuntimeError):
    """Raised by submit/submit_frame after stop(): the worker is gone,
    so enqueueing would park the request forever."""


class DetectionService:
    """Micro-batching co-processor front-end (thread-based).

    Two request classes share the supervised worker thread:
      * windows -- classified in padded micro-batches of ``batch_size``
        (one ``classify_windows`` call on the service's device, so the
        window kernels always see the same batch),
      * frames  -- full multi-scale detection via the device-resident
        FrameDetector (one program per frame-shape bucket).

    Everything runs on the detector's device: CUDA unless ``device="cpu"``
    (or an injected ``frame_detector`` on the CPU). A kernel or CUDA
    failure is never answered from the plain versions or the CPU: it
    fails the request or, when it escapes the batch, the worker, which
    the supervisor retries and the breaker counts.
    """

    def __init__(self, svm: SVMParams, batch_size: int = 64,
                 cfg: HOGConfig = PAPER_HOG, path: str = "ref",
                 max_wait_ms: float = 2.0,
                 detector: Optional[DetectorConfig] = None,
                 frame_batch: int = 8,
                 max_pending_frames: int = 256,
                 frame_detector: Optional[FrameDetector] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 faults: Optional[FaultInjector] = None,
                 cascade: Optional[Any] = None,
                 metrics: Optional[MetricsConfig] = None,
                 device=None):
        if cascade is not None:
            raise NotImplementedError(
                "DetectionService(cascade=...): the cascade and coarse "
                "ladder rungs (core/cascade.py:CascadeDetector) are a "
                "later slice of the port (cascade)")
        self.svm = svm
        self.batch = batch_size
        self.cfg = cfg
        self.path = path
        self.max_wait = max_wait_ms / 1e3
        self.frame_batch = max(1, frame_batch)
        self.max_pending_frames = max_pending_frames
        self.q: "queue.Queue[DetectionRequest]" = queue.Queue()
        self.frame_q: "queue.Queue[FrameRequest]" = \
            queue.Queue(maxsize=max_pending_frames)
        # same-arrival-order parking spot for requests whose shape
        # bucket did not match the batch being formed
        self._frame_backlog: "collections.deque[FrameRequest]" = \
            collections.deque()
        # accepted-but-unanswered frame requests, wherever they sit
        # (queue, backlog, or the worker's hands) -- the number the
        # backpressure valve actually bounds
        self._pending_frames = 0
        self._pending_lock = threading.Lock()
        self._work = threading.Event()
        self._stop = False
        self._stopped = False
        # an injected handle (DetectionSession.serve) shares the
        # session's per-bucket programs; otherwise build our own
        if frame_detector is not None:
            if device is not None and not _same_device(
                    resolve_device(device), frame_detector.device):
                raise ValueError(
                    f"device={device!r}, but the injected frame_detector "
                    f"runs on {frame_detector.device}")
            self._detector = frame_detector
        else:
            self._detector = FrameDetector(
                svm, detector if detector is not None
                else DetectorConfig(hog=cfg, backend=path), device=device)
        self.device = self._detector.device
        # the window step's parameters, on the service's device once
        self._window_svm = as_svm(svm, self.device, cfg.n_features)
        # the detector's data mesh multiplies the per-dispatch frame
        # target: one batched step can feed frame_batch frames to each
        # of the detector's devices
        self.devices = max(1, getattr(self._detector, "data_devices", 1))
        self.frame_target = self.frame_batch * self.devices

        # ----------------------------------------------- resilience seam
        self.res = resilience if resilience is not None \
            else ResilienceConfig()
        self.faults = faults
        self._retry = self.res.retry
        self._backoff_rng = random.Random(self._retry.seed)
        self._breaker = CircuitBreaker(self.res.breaker_failures,
                                       self.res.breaker_reset_s)
        self._latency = RollingLatency(self.res.latency_window)
        # ladder rungs from what this deployment can fall back to: the
        # reduced-pyramid detector (same head, first scale only); the
        # cascade -> coarse rungs come with the cascade slice
        rungs = ("full", "reduced")
        self._reduced = reduced_detector(self._detector)
        self._ladder = DegradationLadder(
            rungs, degrade_p99_ms=self.res.degrade_p99_ms,
            recover_p99_ms=self.res.recover_p99_ms,
            degrade_depth=self.res.degrade_depth,
            recover_dwell=self.res.recover_dwell)
        # requests in the worker's hands (popped but unanswered): the
        # supervisor retries/fails these on worker death, stop() sweeps
        # them so a wedged worker cannot hang its clients
        self._inflight: List[FrameRequest] = []
        self._inflight_windows: List[DetectionRequest] = []

        # ------------------------------------------ metrics export (§15)
        # structured events out of process (obs/metrics.py): the
        # supervisor loop and the batch path emit through one Emitter
        # (rank-0 guarded, never raising into the serve loop); disabled
        # config -> NullSink -> every emit is a cheap no-op
        self.metrics = metrics if metrics is not None else MetricsConfig()
        sink, self._metrics_ring = make_sink(self.metrics)
        self._emit = Emitter(sink, rank0_only=self.metrics.rank0_only)

        self.worker_error: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True, name="repro-supervisor")
        self.stats = {"batches": 0, "requests": 0, "occupancy": 0.0,
                      "frames": 0, "frame_ms": 0.0, "frame_boxes": 0,
                      "frame_batches": 0, "frame_occupancy": 0.0,
                      "frame_rejects": 0, "frames_saturated": 0,
                      # kept-box counts per head label on multi-class
                      # sessions ({} until a labelled detection lands)
                      "class_boxes": {},
                      "devices": self.devices,
                      "tile_devices": max(
                          1, getattr(self._detector, "frame_devices", 1)),
                      "device_frames": [0] * self.devices,
                      "per_device_occupancy": [0.0] * self.devices,
                      # -------------------- resilience telemetry (§14)
                      "frame_answers": 0,       # every resolved future
                      "frame_errors": 0,        # error-payload answers
                      "deadline_shed": 0,       # shed before compute
                      "retries": 0,             # in-flight re-queues
                      "restarts": 0,            # supervised respawns
                      "worker_failures": 0,     # escapes from the loop
                      "frames_degraded": 0,     # served below "full"
                      "latency_ms": self._latency.snapshot(),
                      "breaker": self._breaker.snapshot(),
                      "degraded_mode": self._ladder.rung,
                      "ladder": self._ladder.snapshot(),
                      # -------------------- environment + export (§15)
                      "platform": platform.describe(),
                      "metrics": {"enabled": self._emit.active,
                                  "emitted": 0, "dropped": 0}}

    def _metrics_stats(self) -> None:
        self.stats["metrics"] = {
            "enabled": self._emit.active,
            "emitted": self._emit._seq,
            "dropped": self._emit.dropped,
            **({"recent": self._metrics_ring.counts()}
               if self._metrics_ring is not None else {})}

    def start(self):
        self._supervisor.start()
        self._emit.emit(
            "service_start",
            rungs=list(self._ladder.rungs),
            frame_batch=self.frame_batch, devices=self.devices,
            frame_target=self.frame_target,
            max_pending_frames=self.max_pending_frames,
            deadline_ms=self.res.deadline_ms,
            platform=self.stats["platform"])
        return self

    def stop(self):
        """Stop the supervisor + worker; a backlog is answered with
        errors, never left hanging in `fut.get()`. Returns within the
        join timeouts even when a worker is wedged mid-batch: the
        final drain sweeps queued, parked, AND in-flight requests
        (answers are exactly-once, so a late worker answer is a no-op).
        """
        self._stopped = True
        self._stop = True
        self._work.set()                  # wake an idle worker at once
        for t in (self._thread, self._supervisor):
            if t is not None and t.ident is not None \
                    and t is not threading.current_thread():
                t.join(timeout=5)
        # requests still pending (worker never started, died, or the
        # join timed out mid-batch) would otherwise hang their clients
        self._drain_pending("DetectionService stopped with a backlog")
        self._emit.emit(
            "service_stop",
            frames=self.stats["frames"], batches=self.stats["frame_batches"],
            answers=self.stats["frame_answers"],
            errors=self.stats["frame_errors"],
            deadline_shed=self.stats["deadline_shed"],
            retries=self.stats["retries"], restarts=self.stats["restarts"],
            worker_failures=self.stats["worker_failures"],
            frames_degraded=self.stats["frames_degraded"],
            latency_ms=self.stats["latency_ms"],
            ladder=self.stats["ladder"], breaker=self.stats["breaker"])
        self._metrics_stats()
        self._emit.close()

    def _drain_pending(self, msg: str) -> int:
        """Answer every queued/parked/in-flight request with an error
        payload; returns how many were drained. Called on stop(), on
        breaker-open admission draining, and when the supervisor exits
        -- the no-hanging-futures rule."""
        n = 0
        while True:
            try:
                # popleft-or-IndexError IS the emptiness check: stop()
                # and the worker's exit drain can run concurrently, so
                # a check-then-pop would race (deque ops are atomic)
                req = self._frame_backlog.popleft()
            except IndexError:
                try:
                    req = self.frame_q.get_nowait()
                except queue.Empty:
                    break
            if self._answer_frame(req, {"detections": [], "ms": 0.0,
                                        "error": msg}):
                n += 1
        # in-flight sweep: answered-flag answers make this idempotent
        # against a worker that resolves the same request late
        for req in list(self._inflight):
            if self._answer_frame(req, {"detections": [], "ms": 0.0,
                                        "error": msg}):
                n += 1
        for r in list(self._inflight_windows):
            try:
                r.future.put_nowait({"score": float("nan"), "human": -1,
                                     "error": msg})
                n += 1
            except queue.Full:
                pass
        while True:
            try:
                r = self.q.get_nowait()
            except queue.Empty:
                break
            r.future.put({"score": float("nan"), "human": -1,
                          "error": msg})
            n += 1
        return n

    # ------------------------------------------------------- window path
    def submit(self, window: np.ndarray) -> "queue.Queue":
        self._check_admission()
        fut: "queue.Queue" = queue.Queue(maxsize=1)
        self.q.put(DetectionRequest(window, fut))
        if self._stopped:
            # stop() may have drained between the admission check and
            # this enqueue: answer the straggler ourselves
            self._drain_pending("DetectionService stopped with a backlog")
        self._work.set()
        return fut

    def detect(self, windows: List[np.ndarray],
               timeout: float = 30.0) -> List[Dict[str, float]]:
        futs = [self.submit(w) for w in windows]
        return [f.get(timeout=timeout) for f in futs]

    # -------------------------------------------------------- frame path
    def _check_admission(self) -> None:
        if self._stopped:
            raise ServiceStopped(
                "DetectionService.stop() was called; a request "
                "submitted now could never be served")
        if not self._breaker.admit():
            raise CircuitOpen(
                f"circuit open after {self._breaker.consecutive} "
                f"consecutive worker failures; admission fails fast "
                f"for {self.res.breaker_reset_s:.1f}s (see .worker_error)")

    def submit_frame(self, frame: np.ndarray,
                     deadline_ms: Optional[float] = None) -> "queue.Queue":
        """Enqueue one frame. `deadline_ms` caps the request's time in
        the system (default: config's `resilience.deadline_ms`; 0 or
        None = no deadline): a request still unserved when its budget
        expires is shed BEFORE compute and answered with a
        `DeadlineExceeded` payload. Raises `ServiceStopped` after
        stop(), `CircuitOpen` while the breaker fails fast, and
        `ServiceOverloaded` when the pending bound is hit."""
        self._check_admission()
        fut: "queue.Queue" = queue.Queue(maxsize=1)
        dl = deadline_ms if deadline_ms is not None \
            else (self.res.deadline_ms or None)
        now = time.monotonic()
        req = FrameRequest(frame, fut, t_submit=now,
                           deadline=None if not dl else now + dl / 1e3)
        # the bound counts every accepted-but-unanswered request --
        # queued, parked in the bucket backlog, or in the worker's
        # hands -- so shuffling between holding areas cannot grow total
        # pending work past max_pending_frames
        with self._pending_lock:
            if self._pending_frames >= self.max_pending_frames:
                self.stats["frame_rejects"] += 1
                raise ServiceOverloaded(
                    f"{self.max_pending_frames} frames pending; "
                    f"shed load or retry")
            self._pending_frames += 1
        try:
            self.frame_q.put_nowait(req)
        except queue.Full:                    # maxsize == the same bound,
            with self._pending_lock:          # so only a relic race path
                self._pending_frames -= 1
            self.stats["frame_rejects"] += 1
            raise ServiceOverloaded(
                f"frame queue full ({self.frame_q.maxsize} pending); "
                f"shed load or retry") from None
        if self._stopped:
            # stop() may have drained between the admission check and
            # this enqueue: answer the straggler ourselves
            self._drain_pending("DetectionService stopped with a backlog")
        self._work.set()
        return fut

    def _answer_frame(self, req: FrameRequest, payload: Dict) -> bool:
        """Resolve a frame request's future and release its pending
        slot -- the ONLY way frame futures are answered, and EXACTLY
        once per request (the answered flag makes concurrent answer
        attempts -- worker vs drain -- race-free)."""
        with self._pending_lock:
            if req.answered:
                return False
            req.answered = True
            self._pending_frames -= 1
        self.stats["frame_answers"] += 1
        if "error" in payload:
            self.stats["frame_errors"] += 1
        try:
            req.future.put_nowait(payload)
        except queue.Full:          # pragma: no cover -- maxsize-1 relic
            pass
        return True

    def detect_frames(self, frames: List[np.ndarray],
                      timeout: float = 120.0,
                      deadline_ms: Optional[float] = None
                      ) -> List[Dict[str, Any]]:
        """Full-frame requests: each result is {detections, ms,
        saturated, degraded_mode} (saturated = the frame's threshold
        candidates overflowed the program's top-k, see api/results.py;
        degraded_mode = the ladder rung that served it); a request
        that raised -- was shed by backpressure, fail-fast admission,
        or its deadline -- carries an extra "error" key instead of
        hanging or aborting the rest of the submission (the worker
        survives bad inputs). Callers that want the hard
        ServiceOverloaded / CircuitOpen signal use submit_frame
        directly."""
        futs: List[Any] = []
        for f in frames:
            try:
                futs.append(self.submit_frame(f, deadline_ms=deadline_ms))
            except ServiceOverloaded as e:
                futs.append({"detections": [], "ms": 0.0,
                             "error": f"{type(e).__name__}: {e}"})
        return [f if isinstance(f, dict) else f.get(timeout=timeout)
                for f in futs]

    # -------------------------------------------------------- supervisor
    def _supervise(self):
        """Worker lifecycle: spawn -> join -> classify the exit.

        A clean exit means stop(); anything else is a worker death the
        supervisor absorbs: restart accounting, breaker bookkeeping
        (done at failure time by `_on_worker_failure`), capped
        exponential backoff + jitter before the respawn. While the
        breaker is open, admission fails fast and anything already
        queued is drained instead of parking until the half-open probe.
        """
        try:
            while not self._stop:
                if not self._breaker.probe_due():
                    # open: answer queued work now, poll for the probe
                    self._drain_pending(
                        f"circuit open ({self._breaker.consecutive} "
                        f"consecutive worker failures); see .worker_error")
                    time.sleep(0.01)
                    continue
                t = threading.Thread(target=self._worker_main,
                                     daemon=True,
                                     name="repro-detect-worker")
                self._thread = t
                t.start()
                t.join()
                if self._stop:
                    break
                # unexpected worker exit: supervised restart. The
                # per-bucket programs live on the FrameDetector
                # (core/detector.py:_programs), which outlives the worker
                # thread, so the respawn costs a thread, not a rebuild.
                self.stats["restarts"] += 1
                self._emit.emit("restart",
                                restarts=self.stats["restarts"],
                                breaker=self._breaker.snapshot())
                delay_s = self._retry.delay_ms(
                    max(1, self._breaker.consecutive),
                    self._backoff_rng) / 1e3
                end = time.monotonic() + delay_s
                while not self._stop and time.monotonic() < end:
                    time.sleep(min(0.005, delay_s))
        finally:
            # supervisor exiting: nobody will ever answer what is still
            # queued -- fail it now, don't hang
            self._drain_pending(
                "DetectionService worker exited with a backlog"
                + (f"; worker_error:\n{self.worker_error}"
                   if self.worker_error else ""))

    def _worker_main(self):
        """One worker incarnation. No blanket per-round containment:
        per-request/per-batch errors are contained inside the serve
        methods; anything that escapes -- including BaseException-grade
        thread kills -- routes through `_on_worker_failure` and exits
        the incarnation for the supervisor to respawn. Grad mode and the
        current CUDA device are per thread in PyTorch, so each
        incarnation sets both for its compute."""
        try:
            card = torch.cuda.device(self.device) \
                if self.device.type == "cuda" else contextlib.nullcontext()
            with torch.inference_mode(), card:
                self._worker_loop()
        except BaseException as exc:   # noqa: B036 -- supervised seam
            self._on_worker_failure(exc)

    def _worker_loop(self) -> None:
        while not self._stop:
            served = self._serve_frame_batch()
            served = self._serve_window_batch() or served
            if not served:
                # idle: block on the wake event (no busy-poll).
                # Clear first, then re-check the queues so a submit
                # racing the clear re-sets the event and the wait
                # returns at once.
                self._work.clear()
                if self.q.empty() and self.frame_q.empty() \
                        and not self._frame_backlog:
                    self._work.wait(timeout=0.05)

    def _on_worker_failure(self, exc: BaseException) -> None:
        """Classify a worker death and settle its in-flight requests:
        deterministic failures (and requests out of retry budget) fail
        fast with the original traceback; transient ones re-queue at
        the FRONT of the backlog, order preserved, for the respawned
        worker."""
        tb = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))
        self.worker_error = tb
        self.stats["worker_failures"] += 1
        deterministic = isinstance(exc, DETERMINISTIC_TYPES)
        inflight, self._inflight = self._inflight, []
        windows, self._inflight_windows = self._inflight_windows, []
        requeue: List[FrameRequest] = []
        for r in inflight:
            if r.answered:
                continue
            r.attempts += 1
            if deterministic or r.attempts >= self._retry.max_attempts:
                kind = ("deterministic failure" if deterministic else
                        f"failed after {r.attempts} attempts")
                self._answer_frame(r, {
                    "detections": [], "ms": 0.0,
                    "degraded_mode": self._ladder.rung,
                    "error": f"worker {kind}:\n{tb}"})
            else:
                self.stats["retries"] += 1
                requeue.append(r)
        for r in reversed(requeue):
            self._frame_backlog.appendleft(r)
        for r in windows:
            try:
                r.future.put_nowait({"score": float("nan"), "human": -1,
                                     "error": f"worker failure:\n{tb}"})
            except queue.Full:
                pass
        self._breaker.record_failure()
        self.stats["breaker"] = self._breaker.snapshot()
        self._emit.emit("worker_failure",
                        error=f"{type(exc).__name__}: {exc}",
                        deterministic=deterministic,
                        requeued=len(requeue),
                        failed_fast=len(inflight) - len(requeue),
                        breaker=self.stats["breaker"])
        self._work.set()             # the next incarnation has work

    # ------------------------------------------------------------ worker
    def _next_frame_req(self) -> Optional[FrameRequest]:
        if self._frame_backlog:
            return self._frame_backlog.popleft()
        try:
            return self.frame_q.get_nowait()
        except queue.Empty:
            return None

    def _shed_expired(self, req: FrameRequest,
                      now: Optional[float] = None) -> bool:
        """Deadline gate: answer an over-budget request with the
        DeadlineExceeded payload BEFORE any compute is spent on it."""
        if req.deadline is None:
            return False
        if (time.monotonic() if now is None else now) <= req.deadline:
            return False
        self.stats["deadline_shed"] += 1
        self._answer_frame(req, {
            "detections": [], "ms": 0.0, "deadline_exceeded": True,
            "degraded_mode": self._ladder.rung,
            "error": "DeadlineExceeded: request budget expired before "
                     "compute"})
        with self._pending_lock:
            depth = self._pending_frames
        self._emit.emit("deadline_shed",
                        shed_total=self.stats["deadline_shed"],
                        queue_depth=depth, rung=self._ladder.rung)
        return True

    def _degraded_result(self, rung: str, frame: np.ndarray
                         ) -> Tuple[List[dict], bool]:
        """Serve one frame on a non-full ladder rung (core/cascade.py
        degraded entry point; "reduced" is the only one until the
        cascade slice). Returns (detections, saturated)."""
        res = self._reduced.detect_raw(frame)
        return res.to_list(), bool(np.any(res.saturated))

    def _serve_frame_batch(self) -> bool:
        """Coalesce same-bucket frame requests into one batched step.

        The first request pins the shape bucket; further requests are
        drained from the backlog/queue until `frame_target` frames
        (`frame_batch` per device of the detector's data mesh) are
        gathered or `max_wait` expires. Mismatched buckets park in the
        backlog (served, in order, on later rounds); malformed frames
        are answered with an error result immediately and never join
        the batch; requests whose deadline expired are shed before
        compute. The fault hook and the batch dispatch run OUTSIDE the
        per-batch containment on purpose: an escape there is a worker
        failure the supervisor handles (retry / fail-fast / restart).
        """
        req = None
        while req is None:
            req = self._next_frame_req()
            if req is None:
                return False
            if self._shed_expired(req):
                req = None
        try:
            bucket = self._detector.bucket_for(req.frame)
        except Exception as e:
            self._answer_frame(req, {"detections": [], "ms": 0.0,
                                     "error": f"{type(e).__name__}: {e}"})
            return True
        group: List[FrameRequest] = [req]
        parked: List[FrameRequest] = []
        deadline = time.monotonic() + self.max_wait
        while len(group) < self.frame_target:
            nxt = None
            if self._frame_backlog:
                nxt = self._frame_backlog.popleft()
            else:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    nxt = self.frame_q.get(timeout=wait)
                except queue.Empty:
                    break
            if self._shed_expired(nxt):
                continue
            try:
                b = self._detector.bucket_for(nxt.frame)
            except Exception as e:
                self._answer_frame(nxt, {"detections": [], "ms": 0.0,
                                         "error": f"{type(e).__name__}: "
                                                  f"{e}"})
                continue
            if b == bucket:
                group.append(nxt)
            else:
                parked.append(nxt)
        self._frame_backlog.extend(parked)

        # last shed pass: the straggler wait may have burned the budget
        now = time.monotonic()
        group = [r for r in group if not self._shed_expired(r, now)]
        if not group:
            return True

        rung = self._ladder.rung
        self._inflight = group
        if self.faults is not None:
            # chaos seam: may sleep (latency spike) or raise (injected
            # worker failure / device loss / thread kill)
            self.faults.before_batch(len(group))

        t_dispatch = time.monotonic()
        t0 = time.perf_counter()
        if rung == "full":
            try:
                if len(group) == 1:
                    results = [self._detector.detect_raw(group[0].frame)]
                else:
                    batch = self._detector.detect_batch_raw(
                        [r.frame for r in group])
                    results = [batch.frame(i) for i in range(len(group))]
                # decode inside the timed region so per-frame ms keeps
                # the legacy meaning (device step + host decode)
                dets_per = [(res.to_list(), bool(np.any(res.saturated)))
                            for res in results]
            except Exception:
                # batch failed as a whole: fall back to per-frame so one
                # poisonous frame cannot fail its innocent batch-mates
                dets_per = []
                for r in group:
                    try:
                        res = self._detector.detect_raw(r.frame)
                        dets_per.append((res.to_list(),
                                         bool(np.any(res.saturated))))
                    except Exception as e:
                        dets_per.append(e)
        else:
            # degraded rung: per-frame through the cheap entry point
            dets_per = []
            for r in group:
                try:
                    dets_per.append(self._degraded_result(rung, r.frame))
                except Exception as e:
                    dets_per.append(e)
        ms = (time.perf_counter() - t0) * 1e3 / len(group)
        self.stats["frame_batches"] += 1
        self._account_device_frames(len(group))
        now = time.monotonic()
        for r, dets in zip(group, dets_per):
            if isinstance(dets, Exception):
                self._answer_frame(
                    r, {"detections": [], "ms": 0.0,
                        "degraded_mode": rung,
                        "error": f"{type(dets).__name__}: {dets}"})
                continue
            dets, saturated = dets
            self.stats["frames"] += 1
            if rung != "full":
                self.stats["frames_degraded"] += 1
            self.stats["frames_saturated"] += int(saturated)
            self.stats["frame_boxes"] += len(dets)
            for d in dets:                       # per-class serve stats
                if "label" in d:
                    cb = self.stats["class_boxes"]
                    cb[d["label"]] = cb.get(d["label"], 0) + 1
            self.stats["frame_ms"] += (ms - self.stats["frame_ms"]) \
                / self.stats["frames"]
            self._latency.add((now - r.t_submit) * 1e3)
            self._answer_frame(r, {"detections": dets, "ms": ms,
                                   "saturated": saturated,
                                   "degraded_mode": rung})
        self._inflight = []
        self.stats["frame_occupancy"] = (
            self.stats["frames"]
            / (self.stats["frame_batches"] * self.frame_target))
        self.stats["per_device_occupancy"] = [
            df / (self.stats["frame_batches"] * self.frame_batch)
            for df in self.stats["device_frames"]]
        # ------------------------------------------- ladder + telemetry
        p99 = self._latency.percentile(99)
        with self._pending_lock:
            depth = self._pending_frames
        self._ladder.observe(p99, depth, len(self._latency))
        self.stats["latency_ms"] = self._latency.snapshot()
        self.stats["degraded_mode"] = self._ladder.rung
        self.stats["ladder"] = self._ladder.snapshot()
        self._breaker.record_success()
        self.stats["breaker"] = self._breaker.snapshot()
        # ------------------------------------------- metrics export (§15)
        if self._emit.active:
            devices_used = 1 if len(group) == 1 \
                else min(self.devices, len(group))
            self._emit.emit(
                "batch", n=len(group), ms_per_frame=round(ms, 3),
                queue_depth=depth, rung=rung,
                latency_ms=self.stats["latency_ms"],
                devices_used=devices_used, devices_total=self.devices,
                occupancy=round(len(group) / self.frame_target, 4))
            if self._ladder.rung != rung:
                self._emit.emit(
                    "rung_transition", rung_from=rung,
                    rung_to=self._ladder.rung, p99_ms=round(p99, 3),
                    queue_depth=depth,
                    direction="degrade" if self._rung_level(
                        self._ladder.rung) > self._rung_level(rung)
                    else "recover")
            if self.metrics.stage_timing:
                queue_ms = [(t_dispatch - r.t_submit) * 1e3 for r in group]
                self._emit.emit(
                    "stage_timing", n=len(group),
                    queue_ms_mean=round(sum(queue_ms) / len(queue_ms), 3),
                    queue_ms_max=round(max(queue_ms), 3),
                    compute_ms_per_frame=round(ms, 3))
            self._metrics_stats()
        return True

    def _rung_level(self, rung: str) -> int:
        """Index of a rung in the ladder (higher = more degraded)."""
        try:
            return self._ladder.rungs.index(rung)
        except (AttributeError, ValueError):
            return 0

    def _account_device_frames(self, g: int) -> None:
        """Attribute one dispatched group of g frames to the devices
        that ran it: the sharded batch program pads g up to the mesh
        size and lays contiguous rows per device, a single-frame
        dispatch runs on device 0. Feeds per_device_occupancy."""
        df = self.stats["device_frames"]
        if g == 1 or self.devices == 1:
            df[0] += g
            return
        local = -(-g // self.devices)      # rows per device, post-pad
        for i in range(self.devices):
            df[i] += min(local, max(0, g - i * local))

    def _serve_window_batch(self) -> bool:
        reqs: List[DetectionRequest] = []
        try:
            reqs.append(self.q.get_nowait())
        except queue.Empty:
            return False
        t0 = time.monotonic()
        while (len(reqs) < self.batch
               and time.monotonic() - t0 < self.max_wait):
            try:
                reqs.append(self.q.get_nowait())
            except queue.Empty:
                time.sleep(0.0005)
        self._inflight_windows = reqs
        n = len(reqs)
        pad = self.batch - n
        try:
            wins = np.stack([r.window for r in reqs]
                            + [np.zeros_like(reqs[0].window)] * pad)
            out = classify_windows(self._window_svm, wins, self.cfg,
                                   self.path, device=self.device)
            score = out["score"].cpu().numpy()
            human = out["human"].cpu().numpy()
        except Exception as e:   # contain: fail the batch, keep serving
            for r in reqs:
                r.future.put({"score": float("nan"), "human": -1,
                              "error": f"{type(e).__name__}: {e}"})
            self._inflight_windows = []
            return True
        for i, r in enumerate(reqs):
            r.future.put({"score": float(score[i]),
                          "human": int(human[i])})
        self._inflight_windows = []
        self.stats["batches"] += 1
        self.stats["requests"] += n
        self.stats["occupancy"] = (self.stats["requests"]
                                   / (self.stats["batches"] * self.batch))
        self._breaker.record_success()
        self.stats["breaker"] = self._breaker.snapshot()
        return True


def generate(params: DenseLM, cfg: ModelConfig, prompt,
             max_new_tokens: int = 32, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> Tensor:
    """Greedy or temperature decoding. prompt: (B, S) token ids, numpy or
    a tensor, moved to the parameters' device -> (B, S + new) int64 on
    that device.

    Greedy decoding (``temperature`` <= 0, or no ``generator``) gives the
    reference's tokens. Temperature sampling draws from ``generator``
    (on the parameters' device): the same distribution as the
    reference's ``jax.random.categorical``, not the same tokens.
    """
    dev = params.device
    prompt = torch.as_tensor(np.asarray(prompt) if not isinstance(
        prompt, Tensor) else prompt).to(device=dev, dtype=torch.int64)
    B, S = prompt.shape
    logits, cache = prefill(params, {"tokens": prompt}, cfg,
                            max_len=S + max_new_tokens)
    toks = [prompt]
    cur = _sample(logits[:, -1], temperature, generator)
    for t in range(max_new_tokens):
        toks.append(cur)
        if t == max_new_tokens - 1:
            break
        logits, cache = decode_step(params, cur, cache, cfg)
        cur = _sample(logits[:, -1], temperature, generator)
    return torch.cat(toks, dim=1)


def _sample(logits: Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> Tensor:
    """(B, V) logits -> (B, 1) token ids: argmax (the first index of a
    tie, as jnp.argmax), or one draw from softmax(logits / temperature)."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1, keepdim=True)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)
