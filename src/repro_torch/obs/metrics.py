"""Pluggable metrics export: the serve telemetry as a stream of
structured events (DESIGN.md §15). A copy of repro/obs/metrics.py (the
port imports nothing of the reference package), with the rank-0 guard
taken from the port's ``platform.is_main`` and ``_json_default`` turning
torch tensors into numbers and lists.

`DetectionService.stats` holds rolling p50/p99 and the shed, retry,
restart, breaker and ladder counters in process only; this module carries
them out of it. The engine emits plain dicts, a `MetricsSink` decides
where they go, and nothing in the hot path knows (or imports) the
destination.

Event schema -- every event is a flat JSON-safe dict with three fields
stamped by the `Emitter` plus kind-specific payload:

    kind             event type (below)          (stamped)
    seq              per-emitter sequence number (stamped)
    t_ms             ms since emitter creation   (stamped)

    service_start    platform snapshot, config knobs
    batch            n frames, latency_ms, queue_depth, rung,
                     devices_used/devices_total occupancy
    rung_transition  rung_from, rung_to, p99_ms, queue_depth, direction
    deadline_shed    n shed, queue_depth, deadline_ms
    worker_failure   error, transient, retries_left, breaker state
    restart          restarts total, breaker state
    service_stop     final counter totals (frames, sheds, restarts, ...)
    stage_timing     per-stage ms from the session timing hook

Sinks: `JsonlSink` (one JSON object per line -- `tail -f`-able and
re-parseable, the round-trip contract tests/test_metrics.py pins),
`RingSink` (bounded in-memory deque for tests and the `stats()` tail),
`CallbackSink` (bridge to whatever process-local consumer), `TeeSink`
(fan-out), `NullSink` (disabled -- the default, zero overhead).

Emission is guarded by `platform.is_main()` (rank 0 only) so a
multi-process run keeps one writer.

This module imports no torch: `repro_torch.api.config` loads it for the
`ServiceConfig.metrics` knob.
"""
from __future__ import annotations

import io
import json
import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Protocol, Tuple, runtime_checkable)


@runtime_checkable
class MetricsSink(Protocol):
    """Anything that accepts structured events. `emit` must be cheap
    and non-raising from the engine's point of view (the Emitter wraps
    it defensively); `close` flushes/releases."""

    def emit(self, event: Dict[str, Any]) -> None: ...

    def close(self) -> None: ...


class NullSink:
    """Metrics disabled: the default. Exists so the engine can emit
    unconditionally without `if sink is not None` at every site."""

    def emit(self, event: Dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink:
    """One JSON object per line, append mode: `tail -f` it live, or
    re-parse it after the run. Writes are line-buffered and locked so
    supervisor-thread and caller-thread events interleave whole-line.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f: Optional[io.TextIOBase] = open(path, "a",
                                                encoding="utf-8")

    def emit(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, sort_keys=True, default=_json_default)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        """Re-parse a JSONL stream (skips blank lines)."""
        out = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out


class RingSink:
    """Bounded in-memory ring: the last `capacity` events, for tests
    and the `stats()["metrics"]` tail. Thread-safe."""

    def __init__(self, capacity: int = 256):
        self._events: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()

    def emit(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(event)

    def close(self) -> None:
        pass

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        return evs

    def counts(self) -> Dict[str, int]:
        return dict(Counter(e.get("kind", "?") for e in self.events()))


class CallbackSink:
    """Bridge to an arbitrary consumer: `fn(event)` per event."""

    def __init__(self, fn: Callable[[Dict[str, Any]], None]):
        self._fn = fn

    def emit(self, event: Dict[str, Any]) -> None:
        self._fn(event)

    def close(self) -> None:
        pass


class TeeSink:
    """Fan one event stream out to several sinks."""

    def __init__(self, sinks: Iterable[MetricsSink]):
        self.sinks: Tuple[MetricsSink, ...] = tuple(sinks)

    def emit(self, event: Dict[str, Any]) -> None:
        for s in self.sinks:
            s.emit(event)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def _json_default(o):
    """Last-resort encoder: numpy scalars and arrays and torch tensors
    reach the sink occasionally (latencies, occupancy); keep the stream
    valid. A 0-d tensor (any device, any dtype) becomes its number
    through ``item()``, a larger one a nested list through ``tolist()``."""
    if hasattr(o, "item"):
        try:
            return o.item()
        except Exception:
            pass
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


@dataclass(frozen=True)
class MetricsConfig:
    """The `ServiceConfig.metrics` knob. All-default == disabled.

    jsonl_path   append events to this JSONL file ("" = off)
    ring         also keep the last N events in memory (0 = off);
                 surfaced as `stats()["metrics"]["recent"]` counts
    rank0_only   only emit from `platform.is_main()` (default True --
                 the multi-host single-writer guard)
    stage_timing forward the session's per-stage timing dict as
                 `stage_timing` events (off by default: it's verbose)
    """

    jsonl_path: str = ""
    ring: int = 0
    rank0_only: bool = True
    stage_timing: bool = False

    @property
    def enabled(self) -> bool:
        return bool(self.jsonl_path) or self.ring > 0


def make_sink(cfg: MetricsConfig,
              extra: Optional[MetricsSink] = None
              ) -> Tuple[MetricsSink, Optional[RingSink]]:
    """Build the sink stack a MetricsConfig describes. Returns the
    (possibly Tee'd) sink plus the RingSink handle when one was made,
    so the engine can surface its counts in `stats()`."""
    sinks: List[MetricsSink] = []
    ring: Optional[RingSink] = None
    if cfg.jsonl_path:
        sinks.append(JsonlSink(cfg.jsonl_path))
    if cfg.ring > 0:
        ring = RingSink(cfg.ring)
        sinks.append(ring)
    if extra is not None:
        sinks.append(extra)
    if not sinks:
        return NullSink(), None
    sink = sinks[0] if len(sinks) == 1 else TeeSink(sinks)
    return sink, ring


class Emitter:
    """What the engine actually holds: stamps kind/seq/t_ms, applies
    the rank-0 guard once at construction, and swallows sink errors so
    a full disk can never take the serve loop down (first failure is
    recorded in `dropped`)."""

    def __init__(self, sink: MetricsSink, rank0_only: bool = True):
        self._sink = sink
        self._seq = 0
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self.dropped = 0
        self.last_error: Optional[str] = None
        if rank0_only:
            from .. import platform as _platform
            self._active = _platform.is_main()
        else:
            self._active = True
        if isinstance(sink, NullSink):
            self._active = False

    @property
    def active(self) -> bool:
        return self._active

    def emit(self, kind: str, **payload) -> None:
        if not self._active:
            return
        with self._lock:
            seq = self._seq
            self._seq += 1
        event = {"kind": kind, "seq": seq,
                 "t_ms": round((time.perf_counter() - self._t0) * 1e3, 3)}
        event.update(payload)
        try:
            self._sink.emit(event)
        except Exception as exc:             # noqa: BLE001 - never fatal
            self.dropped += 1
            self.last_error = f"{type(exc).__name__}: {exc}"

    def close(self) -> None:
        try:
            self._sink.close()
        except Exception as exc:             # noqa: BLE001
            self.last_error = f"{type(exc).__name__}: {exc}"
