"""The configuration tree of the port's detection API -- the port of
repro/api/config.py.

``PipelineConfig`` nests the typed ``hog``, ``detector``, ``tracker``
(core/video.py:TrackerConfig) and ``train`` (core/svm.py:SVMTrainConfig)
configs the port runs. The ``service`` and ``cascade`` sub-trees belong
to paths a later slice ports; they are kept as plain dicts and
round-trip unchanged, so a reference ``PipelineConfig.to_dict()`` loads
and dumps back equal. Their defaults are copies of the reference
dataclasses' defaults (repro/api/config.py:66 ServiceConfig with
serve/resilience.py and obs/metrics.py nested, repro/core/cascade.py:60
CascadeConfig).

Presets: "default", "paper", "faithful", "perf", "quant" (from
configs/hog_svm.py).
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

SERVICE_DEFAULT = {
    "window_batch": 64, "max_wait_ms": 2.0, "frame_batch": 8,
    "max_pending_frames": 256,
    "resilience": {
        "deadline_ms": 0.0,
        "retry": {"max_attempts": 3, "backoff_base_ms": 5.0,
                  "backoff_cap_ms": 200.0, "jitter": 0.5, "seed": 0},
        "breaker_failures": 5, "breaker_reset_s": 5.0,
        "degrade_p99_ms": 0.0, "recover_p99_ms": 0.0, "degrade_depth": 0,
        "recover_dwell": 3, "latency_window": 64},
    "metrics": {"jsonl_path": "", "ring": 0, "rank0_only": True,
                "stage_timing": False}}
CASCADE_DEFAULT = {"enabled": False, "coarse_scales": (0.5, 0.4, 0.32),
                   "coarse_threshold": 0.0, "coarse_max_detections": 64,
                   "margin": 24, "snap": 36, "max_regions": 4,
                   "min_frame_area": 0, "fine_hysteresis": 0.0}


def _default(d: Dict[str, Any]):
    return dataclasses.field(default_factory=lambda: copy.deepcopy(d))


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
    service: Dict[str, Any] = _default(SERVICE_DEFAULT)
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
