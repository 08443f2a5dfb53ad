"""Resilience primitives for the serving stack (DESIGN.md §14): a copy
of repro/serve/resilience.py (plain Python and numpy; the port imports
nothing of the reference package).

A real-time stream is only as good as its worst frame: the service
cannot block on a dead worker, burn compute on a request whose caller
already gave up, or let one slow batch snowball into a backlog of
doomed work. This module holds the four host-side mechanisms the
engine composes -- all plain Python, deterministic, and unit-testable
without a device:

  * `RetryPolicy`    -- capped exponential backoff with seeded jitter;
                        drives both in-flight request retries and the
                        supervisor's restart pacing.
  * `CircuitBreaker` -- closed -> open after N CONSECUTIVE worker
                        failures (fail-fast admission), half-open probe
                        after a cooldown, closed again on success. The
                        clock is injectable so tests never sleep.
  * `RollingLatency` -- fixed-window latency ring with p50/p99; feeds
                        the stats() telemetry and the ladder.
  * `DegradationLadder` -- hysteresis state machine over quality rungs
                        (full -> cascade -> coarse, or full -> reduced):
                        degrade one rung when rolling p99 or queue depth
                        crosses the overload line, climb back one rung
                        only after `recover_dwell` consecutive healthy
                        observations below the (lower) recovery line.

`ResilienceConfig` is the JSON-round-trippable knob block nested into
`api.config.ServiceConfig`; every default is inert (no deadline, ladder
off) so an unconfigured service behaves exactly like the pre-resilience
engine, with supervision and transient-retry always on.
"""
from __future__ import annotations

import collections
import dataclasses
import random
import time
from typing import Optional, Sequence, Tuple

import numpy as np


# -------------------------------------------------------------- policies

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic jitter.

    `delay_ms(attempt)` for attempt = 1, 2, ... doubles from
    `backoff_base_ms` up to `backoff_cap_ms`; `jitter` subtracts up to
    that fraction of the delay, drawn from the caller's seeded rng so a
    chaos run replays byte-identically."""

    max_attempts: int = 3          # total tries per request (1 = never retry)
    backoff_base_ms: float = 5.0
    backoff_cap_ms: float = 200.0
    jitter: float = 0.5            # fraction of the delay jittered away
    seed: int = 0                  # seeds the service's backoff rng

    def delay_ms(self, attempt: int,
                 rng: Optional[random.Random] = None) -> float:
        base = min(float(self.backoff_cap_ms),
                   float(self.backoff_base_ms) * (2 ** max(0, attempt - 1)))
        if self.jitter <= 0.0:
            return base
        r = (rng if rng is not None
             else random.Random(self.seed * 1000003 + attempt)).random()
        return base * (1.0 - float(self.jitter) * r)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Serving resilience knobs (engine defaults are inert).

    deadline_ms        per-request compute budget; expired requests are
                       shed BEFORE compute with a DeadlineExceeded
                       payload (0 = no deadline)
    retry              in-flight retry + restart backoff policy
    breaker_failures   consecutive worker failures that trip the
                       circuit breaker to fail-fast admission
    breaker_reset_s    open -> half-open probe cooldown
    degrade_p99_ms     rolling-p99 latency that drops the service one
                       ladder rung (0 = ladder disabled)
    recover_p99_ms     p99 below which an observation counts as healthy
                       (0 = degrade_p99_ms / 2) -- the hysteresis band
    degrade_depth      pending-queue depth that also triggers a
                       degrade (0 = depth trigger off)
    recover_dwell      consecutive healthy batches required per upward
                       rung
    latency_window     rolling window size (requests) for p50/p99
    """

    deadline_ms: float = 0.0
    retry: RetryPolicy = RetryPolicy()
    breaker_failures: int = 5
    breaker_reset_s: float = 5.0
    degrade_p99_ms: float = 0.0
    recover_p99_ms: float = 0.0
    degrade_depth: int = 0
    recover_dwell: int = 3
    latency_window: int = 64


# -------------------------------------------------------- circuit breaker

class CircuitBreaker:
    """closed -> open after `max_failures` CONSECUTIVE failures;
    open -> half_open once `reset_after_s` elapses (one probe worker);
    half_open -> closed on the first success, -> open again on failure.

    `admit()` is the submission gate (False = fail fast), `probe_due()`
    is the supervisor's respawn gate (transitions open -> half_open).
    The clock is injectable for deterministic tests."""

    def __init__(self, max_failures: int = 5, reset_after_s: float = 5.0,
                 clock=time.monotonic):
        self.max_failures = max(1, int(max_failures))
        self.reset_after_s = float(reset_after_s)
        self._clock = clock
        self.state = "closed"
        self.consecutive = 0
        self.opened_at: Optional[float] = None

    def record_failure(self) -> None:
        self.consecutive += 1
        if self.consecutive >= self.max_failures:
            self.state = "open"
            self.opened_at = self._clock()

    def record_success(self) -> None:
        self.consecutive = 0
        self.state = "closed"
        self.opened_at = None

    def _cooled(self) -> bool:
        return (self.opened_at is not None
                and self._clock() - self.opened_at >= self.reset_after_s)

    def admit(self) -> bool:
        """May new work enter? False only while open and still cooling
        (a cooled-but-unprobed breaker admits: the probe is due)."""
        return self.state != "open" or self._cooled()

    def probe_due(self) -> bool:
        """Supervisor gate: True when a probe worker should run. An
        open breaker whose cooldown elapsed transitions to half_open."""
        if self.state == "open" and self._cooled():
            self.state = "half_open"
        return self.state != "open"

    def snapshot(self) -> dict:
        return {"state": self.state, "consecutive": self.consecutive}


# ------------------------------------------------------- rolling latency

class RollingLatency:
    """Fixed-size rolling window of per-request latencies (ms)."""

    def __init__(self, window: int = 64):
        self._buf: "collections.deque[float]" = \
            collections.deque(maxlen=max(1, int(window)))

    def add(self, ms: float) -> None:
        self._buf.append(float(ms))

    def __len__(self) -> int:
        return len(self._buf)

    def percentile(self, p: float) -> float:
        if not self._buf:
            return 0.0
        return float(np.percentile(np.asarray(self._buf), p))

    def snapshot(self) -> dict:
        return {"p50": round(self.percentile(50), 3),
                "p99": round(self.percentile(99), 3),
                "window": len(self._buf)}


# ---------------------------------------------------- degradation ladder

class DegradationLadder:
    """Hysteresis state machine over quality rungs.

    `rungs[0]` is the full pipeline; each later rung is cheaper and
    lower quality. `observe(p99_ms, depth, n_samples)` runs once per
    served batch: overload (p99 >= degrade_p99_ms with a full enough
    window, OR depth >= degrade_depth) drops ONE rung immediately;
    recovery requires `recover_dwell` CONSECUTIVE healthy observations
    (p99 <= recover_p99_ms AND depth <= degrade_depth / 2) per upward
    rung -- the hysteresis band that stops flapping. With both triggers
    at 0 the ladder is inert and `rung` stays `rungs[0]`."""

    def __init__(self, rungs: Sequence[str],
                 degrade_p99_ms: float = 0.0,
                 recover_p99_ms: float = 0.0,
                 degrade_depth: int = 0,
                 recover_dwell: int = 3,
                 min_samples: int = 4):
        if not rungs:
            raise ValueError("ladder needs at least one rung")
        self.rungs: Tuple[str, ...] = tuple(rungs)
        self.degrade_p99_ms = float(degrade_p99_ms)
        self.recover_p99_ms = (float(recover_p99_ms) if recover_p99_ms > 0
                               else self.degrade_p99_ms / 2.0)
        self.degrade_depth = int(degrade_depth)
        self.recover_dwell = max(1, int(recover_dwell))
        self.min_samples = max(1, int(min_samples))
        self.level = 0
        self.transitions = 0
        self._healthy = 0

    @property
    def enabled(self) -> bool:
        return (self.degrade_p99_ms > 0 or self.degrade_depth > 0) \
            and len(self.rungs) > 1

    @property
    def rung(self) -> str:
        return self.rungs[self.level]

    def observe(self, p99_ms: float, depth: int, n_samples: int) -> str:
        if not self.enabled:
            return self.rung
        overload = ((self.degrade_p99_ms > 0
                     and n_samples >= self.min_samples
                     and p99_ms >= self.degrade_p99_ms)
                    or (self.degrade_depth > 0
                        and depth >= self.degrade_depth))
        healthy = ((self.degrade_p99_ms <= 0
                    or p99_ms <= self.recover_p99_ms)
                   and (self.degrade_depth <= 0
                        or depth <= self.degrade_depth // 2))
        if overload:
            self._healthy = 0
            if self.level < len(self.rungs) - 1:
                self.level += 1
                self.transitions += 1
        elif healthy and self.level > 0:
            self._healthy += 1
            if self._healthy >= self.recover_dwell:
                self.level -= 1
                self.transitions += 1
                self._healthy = 0
        else:
            self._healthy = 0
        return self.rung

    def snapshot(self) -> dict:
        return {"rung": self.rung, "level": self.level,
                "rungs": list(self.rungs),
                "transitions": self.transitions}
