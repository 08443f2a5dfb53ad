"""DetectionSession -- the host-facing entry point of the port (the port
of repro/api/session.py, single-frame part).

    session = DetectionSession(svm, presets("paper"))        # on the card
    dets = session.detect(frame)          # -> Detections (lazy decode)

The session owns the SVM parameters, as tensors on its device, and one
FrameDetector, whose per-bucket programs it reuses across calls. It runs
on CUDA unless built with ``device="cpu"``; without a GPU anything else
raises RuntimeError. Training, checkpoints, batches, streams, serving and
the cascade are later slices.
"""
from __future__ import annotations

from typing import Union

from .config import PipelineConfig, presets
from .results import Detections
from ..core.detector import BATCH_LATER, FrameDetector

ConfigLike = Union[PipelineConfig, str, None]


def _as_config(config: ConfigLike) -> PipelineConfig:
    if config is None:
        return PipelineConfig()
    if isinstance(config, str):
        return presets(config)
    return config


class DetectionSession:
    """SVM params + one PipelineConfig -> single-frame detection.

    ``svm`` is a mapping {"w": (3780,), "b": ()} of numpy arrays or
    tensors (see repro_torch.convert.svm_from_numpy).
    """

    def __init__(self, svm, config: ConfigLike = None, device=None):
        self.config = _as_config(config)
        self.detector = FrameDetector(svm, self.config.detector, device)
        self.device = self.detector.device
        self.svm = self.detector.svm

    def detect(self, image) -> Detections:
        """One frame ((H, W) gray or (H, W, 3) RGB, numpy or tensor) ->
        Detections, device-resident until decoded."""
        return self.detector.detect_raw(image)

    def detect_batch(self, frames):
        raise NotImplementedError(BATCH_LATER)
