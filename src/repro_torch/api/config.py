"""The configuration tree of the port's detection API -- the port of
repro/api/config.py.

``PipelineConfig`` nests the typed ``hog``, ``detector``, ``tracker``
(core/video.py:TrackerConfig), ``train`` (core/svm.py:SVMTrainConfig)
and ``service`` (``ServiceConfig``, with serve/resilience.py's
``ResilienceConfig`` and obs/metrics.py's ``MetricsConfig`` nested)
configs the port runs. The ``cascade`` sub-tree belongs to a later slice
(cascade); it is kept as a plain dict and round-trips unchanged, so a
reference ``PipelineConfig.to_dict()`` loads and dumps back equal. Its
default is a copy of the reference dataclass's defaults
(repro/core/cascade.py:60 CascadeConfig).

Presets: "default", "paper", "faithful", "perf", "quant" (from
configs/hog_svm.py); ``register_preset`` adds deployment-local ones.
"""
from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, Optional

from ..configs import hog_svm
from ..core.detector import DetectorConfig
from ..core.hog import HOGConfig, PAPER_HOG
from ..core.svm import SVMTrainConfig
from ..core.video import TrackerConfig
from ..obs.metrics import MetricsConfig
from ..serve.resilience import ResilienceConfig

CASCADE_DEFAULT = {"enabled": False, "coarse_scales": (0.5, 0.4, 0.32),
                   "coarse_threshold": 0.0, "coarse_max_detections": 64,
                   "margin": 24, "snap": 36, "max_regions": 4,
                   "min_frame_area": 0, "fine_hysteresis": 0.0}


def _default(d: Dict[str, Any]):
    return dataclasses.field(default_factory=lambda: copy.deepcopy(d))


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
    cascade: Dict[str, Any] = _default(CASCADE_DEFAULT)

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

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def _tuples(v):
    """JSON lists back to the tuples the config tree holds, recursively."""
    if isinstance(v, dict):
        return {k: _tuples(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(_tuples(x) for x in v)
    return v


def _build(cls, d: Dict[str, Any]):
    """Rebuild a (nested) config dataclass from a plain dict. Typed
    sub-trees are rebuilt from their class defaults; the plain-dict
    sub-trees are copied with lists turned back into tuples."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.default) and isinstance(v, dict):
            v = _build(type(f.default), v)
        elif isinstance(v, (dict, list)):    # JSON has no tuples
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
    # the fixed-point datapath, fused dense backend
    # (repro/api/config.py:229-233)
    "quant": PipelineConfig(
        name="quant", hog=hog_svm.QUANT,
        detector=DetectorConfig(hog=hog_svm.QUANT, score_threshold=0.5,
                                backend="fused", batch_chunk=0),
        train=hog_svm.TRAIN),
}
