"""DetectionSession -- the host-facing entry point of the port (the port
of repro/api/session.py: single frames, batches and tracked clips).

    session = DetectionSession(svm, presets("paper"))        # on the card
    dets = session.detect(frame)          # -> Detections (lazy decode)
    batch = session.detect_batch(frames)  # -> batched Detections
    tracked = session.stream(clip)        # -> [Detections] with track ids

The session owns the SVM parameters, as tensors on its device, and one
FrameDetector, whose per-bucket programs it reuses across calls. It runs
on CUDA unless built with ``device="cpu"``; without a GPU anything else
raises RuntimeError. Training, checkpoints, serving and the cascade are
later slices.
"""
from __future__ import annotations

from typing import List, Optional, Union

from .config import PipelineConfig, presets
from .results import Detections
from ..core.detector import FrameDetector
from ..core.video import Tracker

ConfigLike = Union[PipelineConfig, str, None]


def _as_config(config: ConfigLike) -> PipelineConfig:
    if config is None:
        return PipelineConfig()
    if isinstance(config, str):
        return presets(config)
    return config


class DetectionSession:
    """SVM params + one PipelineConfig -> frame, batch and clip detection.

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

    def detect_batch(self, frames) -> Detections:
        """Stacked (B, H, W[, 3]) array or frame list -> one batched
        Detections; all frames in one shape bucket (the detector's
        contract)."""
        return self.detector.detect_batch_raw(frames)

    def stream(self, frames, batch_size: int = 8,
               tracker: Optional[Tracker] = None) -> List[Detections]:
        """Recorded clip -> per-frame TRACKED detections.

        Detection runs through the batched device path in ``batch_size``
        chunks; the IoU tracker (config.tracker) associates in frame
        order, so ``to_list()`` entries carry track_id/hits/misses. Pass
        a Tracker to keep identities across several stream() calls.
        """
        trk = Tracker(self.config.tracker) if tracker is None else tracker
        n = len(frames)
        out: List[Detections] = []
        for i in range(0, n, max(1, batch_size)):
            chunk = [frames[j] for j in range(i, min(i + batch_size, n))]
            per_frame = (self.detector.detect_batch(chunk)
                         if len(chunk) > 1 else [self.detector(chunk[0])])
            out.extend(Detections.from_list(trk.update(d))
                       for d in per_frame)
        return out
