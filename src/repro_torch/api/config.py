"""The configuration tree of the port's detection API -- the port of
repro/api/config.py.

``PipelineConfig`` nests the typed ``hog``, ``detector``, ``tracker``
(core/video.py:TrackerConfig), ``train`` (core/svm.py:SVMTrainConfig),
``service`` (``ServiceConfig``, with serve/resilience.py's
``ResilienceConfig`` and obs/metrics.py's ``MetricsConfig`` nested) and
``cascade`` (core/cascade.py:CascadeConfig) configs, so a reference
``PipelineConfig.to_dict()`` loads and dumps back equal.

Presets: "default", "paper", "faithful", "perf", "sharded", "uhd",
"quant", "cascade" and "resilient" (from configs/hog_svm.py);
``register_preset`` adds deployment-local ones. "sharded" lays batches
over every visible device, "uhd" tiles one big frame over them with the
banded resize (core/detector.py). "cascade" turns on the two-stage scheduler
(``DetectionSession.cascade``); "resilient" is the serving-SLO
deployment: 500 ms request budgets, retry with backoff, a 5-failure
breaker, and the cascade-backed ladder full -> cascade -> coarse (p99 >=
120 ms or 32 pending frames drops a rung).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

from ..configs import hog_svm
from ..core.cascade import CascadeConfig
from ..core.detector import DetectorConfig
from ..core.hog import HOGConfig, PAPER_HOG
from ..core.svm import SVMTrainConfig
from ..core.video import TrackerConfig
from ..obs.metrics import MetricsConfig
from ..serve.resilience import ResilienceConfig, RetryPolicy


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of the DetectionService front-end (serve/engine.py), the
    reference's fields and defaults (repro/api/config.py:76)."""

    window_batch: int = 64        # padded micro-batch of the window path
    max_wait_ms: float = 2.0      # straggler deadline when coalescing
    frame_batch: int = 8          # frames per batched detection step
    max_pending_frames: int = 256  # backpressure bound (ServiceOverloaded)
    # deadlines / retry / breaker / degradation ladder (DESIGN.md §14);
    # the defaults are inert -- supervision and transient retry are
    # always on, deadlines and the ladder only when configured
    resilience: ResilienceConfig = ResilienceConfig()
    # structured-event export (obs/metrics.py, DESIGN.md §15); the
    # default is disabled -- a jsonl_path or ring size turns it on
    metrics: MetricsConfig = MetricsConfig()


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Everything one detection deployment needs, as one tree.

    ``hog`` is the single source of the window geometry and numerics
    mode: ``detector.hog`` is forced to match it (a non-default
    ``detector.hog`` with a default ``hog`` promotes the detector's).
    """

    name: str = "default"
    hog: HOGConfig = PAPER_HOG
    detector: DetectorConfig = DetectorConfig()
    tracker: TrackerConfig = TrackerConfig()
    train: SVMTrainConfig = SVMTrainConfig()
    service: ServiceConfig = ServiceConfig()
    cascade: CascadeConfig = CascadeConfig()

    def __post_init__(self):
        if self.detector.hog != self.hog:
            if self.hog == PAPER_HOG:
                object.__setattr__(self, "hog", self.detector.hog)
            else:
                object.__setattr__(
                    self, "detector",
                    dataclasses.replace(self.detector, hog=self.hog))

    def to_dict(self) -> Dict[str, Any]:
        """Nested plain-python dict (json.dumps-able as is)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineConfig":
        """Inverse of to_dict; accepts JSON-decoded dicts."""
        return _build(cls, d)

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "PipelineConfig":
        """Inverse of to_json (the reference's JSON text too)."""
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def _tuples(v):
    """JSON lists back to the tuples the config tree holds, recursively."""
    if isinstance(v, (list, tuple)):
        return tuple(_tuples(x) for x in v)
    return v


def _build(cls, d: Dict[str, Any]):
    """Rebuild a (nested) config dataclass from a plain dict; typed
    sub-trees are rebuilt from their class defaults, JSON lists turned
    back into tuples."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.default) and isinstance(v, dict):
            v = _build(type(f.default), v)
        elif isinstance(v, list):            # JSON has no tuples
            v = _tuples(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def register_preset(name: str, cfg: PipelineConfig) -> PipelineConfig:
    _PRESETS[name] = cfg
    return cfg


def presets(name: Optional[str] = None):
    """presets() -> registered names; presets(name) -> PipelineConfig."""
    if name is None:
        return tuple(sorted(_PRESETS))
    try:
        return _PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; registered: "
            f"{', '.join(sorted(_PRESETS))}") from None


#: the reference's presets of the same names (repro/api/config.py:170)
_PRESETS: Dict[str, PipelineConfig] = {
    "default": PipelineConfig(),
    "paper": PipelineConfig(
        name="paper", hog=hog_svm.CONFIG,
        detector=DetectorConfig(hog=hog_svm.CONFIG, score_threshold=0.5),
        train=hog_svm.TRAIN),
    "faithful": PipelineConfig(
        name="faithful", hog=hog_svm.FAITHFUL,
        detector=DetectorConfig(hog=hog_svm.FAITHFUL, score_threshold=0.5),
        train=hog_svm.TRAIN),
    "perf": PipelineConfig(
        name="perf", hog=hog_svm.PERF,
        detector=DetectorConfig(hog=hog_svm.PERF, score_threshold=0.5,
                                backend="fused", batch_chunk=0),
        train=hog_svm.TRAIN),
    # the paper numerics on every visible device: the frame batch over
    # the data axis, each device's schedule autotuned
    # (repro/api/config.py:205-211)
    "sharded": PipelineConfig(
        name="sharded", hog=hog_svm.CONFIG,
        detector=DetectorConfig(hog=hog_svm.CONFIG, score_threshold=0.5,
                                data_parallel=0, batch_chunk=0),
        train=hog_svm.TRAIN),
    # single-frame latency on big frames: every visible device tiles one
    # frame's pyramid (row slabs) with the banded resize; frames below
    # 1280x720 keep the untiled program, and auto-K grows top-k with the
    # window grid (repro/api/config.py:212-221)
    "uhd": PipelineConfig(
        name="uhd", hog=hog_svm.CONFIG,
        detector=DetectorConfig(hog=hog_svm.CONFIG, score_threshold=0.5,
                                frame_parallel=0, tile_mode="slab",
                                pyramid_resize="banded",
                                frame_parallel_min_area=1280 * 720,
                                batch_chunk=0),
        train=hog_svm.TRAIN),
    # the fixed-point datapath, fused dense backend
    # (repro/api/config.py:229-233)
    "quant": PipelineConfig(
        name="quant", hog=hog_svm.QUANT,
        detector=DetectorConfig(hog=hog_svm.QUANT, score_threshold=0.5,
                                backend="fused", batch_chunk=0),
        train=hog_svm.TRAIN),
    # the two-stage scheduler (repro/api/config.py:235-242)
    "cascade": PipelineConfig(
        name="cascade", hog=hog_svm.CONFIG,
        detector=DetectorConfig(hog=hog_svm.CONFIG, score_threshold=0.5),
        train=hog_svm.TRAIN,
        cascade=CascadeConfig(enabled=True)),
    # the serving-SLO deployment (repro/api/config.py:243-260)
    "resilient": PipelineConfig(
        name="resilient", hog=hog_svm.CONFIG,
        detector=DetectorConfig(hog=hog_svm.CONFIG, score_threshold=0.5),
        train=hog_svm.TRAIN,
        cascade=CascadeConfig(enabled=True),
        service=ServiceConfig(resilience=ResilienceConfig(
            deadline_ms=500.0,
            retry=RetryPolicy(max_attempts=3, backoff_base_ms=5.0,
                              backoff_cap_ms=200.0),
            breaker_failures=5, breaker_reset_s=5.0,
            degrade_p99_ms=120.0, degrade_depth=32,
            recover_dwell=3))),
}
