"""Deterministic fault injection for the serving stack (DESIGN.md §14):
a copy of repro/serve/faults.py (the port imports nothing of the
reference package).

Chaos you cannot replay is chaos you cannot debug: every fault here
fires either at an explicit batch index or from a SEEDED Bernoulli
draw, so a failing chaos run reproduces byte-identically from its seed.
The engine calls `FaultInjector.before_batch(...)` at exactly one
point -- after a frame micro-batch is formed and deadline-shed, before
any compute -- and passes `faults=None` (the default) to compile the
hook out entirely in production.

Fault taxonomy (what the supervisor does with each):

  * `TransientFault` / `SimulatedDeviceLoss` -- retryable: in-flight
    requests are re-queued (capped exponential backoff + jitter,
    `RetryPolicy`) and the worker restarts.
  * `DeterministicFault` -- NOT retryable: in-flight requests fail
    fast with the original traceback; retrying a deterministic bug
    only burns the latency budget of a doomed request.
  * `WorkerKilled` -- subclasses BaseException so it sails past every
    `except Exception` containment layer, exactly like a real thread
    death; the supervisor must respawn the worker from scratch.
  * latency faults -- `time.sleep` before compute: the p99 spike that
    drives the degradation ladder in tests and benchmarks.

`DETERMINISTIC_TYPES` is the engine's classification table for
UNINJECTED exceptions too: a ValueError escaping the worker is a bug
that will recur on retry, so it fails fast; anything else is assumed
transient and retried within the policy's attempt budget. A refused
CUDA launch raises RuntimeError (kernels/build.py:launch), so, like an
XLA runtime error in the reference, it counts as transient and is
retried; after a fault that poisons the CUDA context every retry fails
too, and the breaker opens.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import List, Optional, Tuple

import numpy as np


# ------------------------------------------------------------ fault types

class FaultError(RuntimeError):
    """Base class of injected serving faults."""


class TransientFault(FaultError):
    """Injected failure that would succeed on retry (network blip,
    spurious runtime error): the supervisor retries in-flight requests."""


class DeterministicFault(FaultError):
    """Injected failure that recurs on every retry (poisoned input,
    code bug): in-flight requests fail fast with the traceback."""


class SimulatedDeviceLoss(TransientFault):
    """The accelerator disappeared mid-batch; retryable -- the restarted
    worker re-dispatches onto the (recovered or remaining) devices."""


class WorkerKilled(BaseException):
    """Simulated hard thread death. Deliberately NOT an Exception: it
    escapes every `except Exception` containment exactly like a killed
    thread, so only the supervisor's BaseException net catches it."""


#: exception classes the supervisor treats as deterministic (fail the
#: in-flight request fast, with traceback, instead of retrying)
DETERMINISTIC_TYPES: Tuple[type, ...] = (
    DeterministicFault, ValueError, TypeError, KeyError, IndexError,
    AttributeError, AssertionError, ZeroDivisionError)

_KINDS = ("exception", "latency", "device_loss", "kill_worker")


# ------------------------------------------------------------ fault plans

@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    kind         "exception" | "latency" | "device_loss" | "kill_worker"
    at_batches   explicit frame-batch indices (0-based dispatch order)
    prob         seeded per-batch Bernoulli (alternative to at_batches)
    max_fires    cap on total firings (0 = unlimited)
    latency_ms   sleep before compute (kind="latency")
    transient    kind="exception": TransientFault vs DeterministicFault
    """

    kind: str
    at_batches: Tuple[int, ...] = ()
    prob: float = 0.0
    max_fires: int = 0
    latency_ms: float = 0.0
    transient: bool = True
    message: str = "injected fault"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {_KINDS}")


class FaultInjector:
    """Seeded, replayable fault schedule. `FaultInjector()` (no specs)
    is the no-op default; the engine also accepts `faults=None`.

    `fired` logs every firing as (batch_index, kind) for test
    assertions; `batches` counts dispatched frame batches."""

    def __init__(self, specs: Tuple[FaultSpec, ...] = (), seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._fires = [0] * len(self.specs)
        self.fired: List[Tuple[int, str]] = []
        self.batches = 0
        self._lock = threading.Lock()

    def before_batch(self, group_size: int) -> None:
        """Engine hook: called once per formed frame micro-batch,
        before compute. Applies latency faults in spec order, then
        raises the first firing failure fault."""
        with self._lock:
            i = self.batches
            self.batches += 1
            firing = []
            for k, s in enumerate(self.specs):
                if s.max_fires and self._fires[k] >= s.max_fires:
                    continue
                hit = i in s.at_batches or (
                    s.prob > 0.0 and self._rng.random() < s.prob)
                if not hit:
                    continue
                self._fires[k] += 1
                self.fired.append((i, s.kind))
                firing.append(s)
        boom: Optional[BaseException] = None
        for s in firing:
            if s.kind == "latency":
                time.sleep(s.latency_ms / 1e3)
            elif boom is None:
                msg = f"{s.message} (batch {i})"
                if s.kind == "kill_worker":
                    boom = WorkerKilled(msg)
                elif s.kind == "device_loss":
                    boom = SimulatedDeviceLoss(msg)
                else:
                    boom = (TransientFault(msg) if s.transient
                            else DeterministicFault(msg))
        if boom is not None:
            raise boom


# ----------------------------------------------------------- frame chaos

def malformed_frame(rng: np.random.Generator) -> np.ndarray:
    """A deterministically-garbage 'frame' (wrong rank/size/dtype) for
    client-side chaos: the service must answer it with an error payload
    without poisoning its batch-mates."""
    kind = int(rng.integers(0, 4))
    if kind == 0:
        return np.zeros((int(rng.integers(1, 9)),), np.uint8)   # rank 1
    if kind == 1:
        return np.zeros((0, 0, 3), np.uint8)                    # empty
    if kind == 2:
        return np.zeros((3, int(rng.integers(1, 5)),
                         int(rng.integers(1, 5)), 3), np.uint8)  # rank 4
    return np.zeros((2, 2), np.float64)                          # tiny


def chaos_specs(seed: int = 0) -> Tuple[FaultSpec, ...]:
    """The standard chaos scenario (`launch.serve --detect --chaos` and
    the serve phase of chip_smoke.py): one worker kill, one transient
    device loss, and a burst of latency spikes, all at fixed batch
    indices so the run replays exactly."""
    del seed  # fixed schedule; the seed knob is for prob-based plans
    return (
        FaultSpec("kill_worker", at_batches=(1,), max_fires=1,
                  message="chaos: worker thread killed"),
        FaultSpec("device_loss", at_batches=(3,), max_fires=1,
                  message="chaos: device lost"),
        FaultSpec("latency", at_batches=(5, 6, 7), latency_ms=60.0,
                  message="chaos: latency spike"),
    )
