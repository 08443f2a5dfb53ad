"""DetectionSession -- the host-facing entry point of the port (the port
of repro/api/session.py: training, checkpoints, single frames, batches
and tracked clips).

    session = DetectionSession.train(presets("paper"))        # on the card
    session = DetectionSession(svm, presets("paper"))         # given weights
    session.save(path); session = DetectionSession.load(path, "paper")
    dets = session.detect(frame)          # -> Detections (lazy decode)
    batch = session.detect_batch(frames)  # -> batched Detections
    tracked = session.stream(clip)        # -> [Detections] with track ids

The session owns the SVM parameters, as tensors on its device, and one
FrameDetector, whose per-bucket programs it reuses across calls. It runs
on CUDA unless built with ``device="cpu"``; without a GPU anything else
raises RuntimeError. ``train`` extracts HOG features, runs Pegasos
(core/svm.py) and mines hard negatives (data/mining.py) on that device;
``save`` / ``load`` use the reference's checkpoint layout
(checkpoint/manager.py), so either package loads the other's. Serving,
the cascade and multi-head registries are later slices.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .config import PipelineConfig, presets
from .results import Detections
from ..core.detector import FrameDetector, resolve_device
from ..core.video import Tracker

ConfigLike = Union[PipelineConfig, str, None]

#: the multi-head registry's manifest (repro/core/heads.py:37)
HEADS_MANIFEST = "heads.json"


def _as_config(config: ConfigLike) -> PipelineConfig:
    if config is None:
        return PipelineConfig()
    if isinstance(config, str):
        return presets(config)
    return config


def _features(windows: np.ndarray, cfg, device: torch.device) -> torch.Tensor:
    """(N, 130, 66, 3) uint8 windows -> (N, 3780) HOG descriptors on
    ``device``, on the plain "ref" stages as the reference trains."""
    from ..core.hog import hog_descriptor
    return hog_descriptor(torch.from_numpy(np.ascontiguousarray(windows))
                          .to(device), cfg)


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
        self.train_losses = None       # set by train()
        self.mined_negatives = 0       # hard negatives added by train()
        self._warm: set = set()
        self._stats = {"frames": 0, "batches": 0, "clips": 0}

    # ------------------------------------------------------ construction
    @classmethod
    def train(cls, config: ConfigLike = None, n_pos: int = 1500,
              n_neg: int = 1000, seed: int = 0, data_cfg=None,
              rng: Optional[np.random.Generator] = None,
              hard_negative_rounds: int = 0, mine_scenes: int = 16,
              device=None) -> "DetectionSession":
        """Train the SVM on synthetic pedestrian windows using the tree's
        ``hog`` geometry and ``train`` schedule, on ``device`` (CUDA
        unless the CPU is asked for). Pass ``rng`` to share a caller's
        stream (it advances by the window draws, then the mined scenes).

        ``hard_negative_rounds`` > 0 adds that many bootstrapping rounds
        (data/mining.py): each sweeps the current head over
        ``mine_scenes`` person-free scenes at a loose threshold and
        retrains with the firing windows as extra negatives."""
        from ..core.svm import train_svm
        from ..data.mining import mine_hard_negatives
        from ..data.synth_pedestrian import PedestrianDataConfig, make_windows
        config = _as_config(config)
        dev = resolve_device(device)
        if rng is None:
            rng = np.random.default_rng(seed)
        x, y = make_windows(n_pos, n_neg,
                            data_cfg or PedestrianDataConfig(), rng)
        feats = _features(x, config.hog, dev)
        labels = torch.from_numpy(y).to(dev)
        svm, losses = train_svm(feats, labels, config.train)
        mined = 0
        for _ in range(int(hard_negative_rounds)):
            neg = mine_hard_negatives(svm, config.detector, mine_scenes,
                                      rng, device=dev)
            if not len(neg):
                break
            mined += len(neg)
            feats = torch.cat([feats, _features(neg, config.hog, dev)])
            labels = torch.cat([labels, labels.new_zeros(len(neg))])
            svm, losses = train_svm(feats, labels, config.train)
        session = cls(svm, config, device=dev)
        session.train_losses = losses
        session.mined_negatives = mined
        return session

    @classmethod
    def load(cls, path: str, config: ConfigLike = None,
             step: Optional[int] = None, device=None) -> "DetectionSession":
        """Restore SVM params saved by ``save`` (checkpoint/manager.py
        layout, either package's); ``step=None`` takes the latest
        committed step. A multi-head directory (a ``heads.json``
        manifest) raises NotImplementedError."""
        from ..checkpoint.manager import CheckpointManager
        config = _as_config(config)
        dev = resolve_device(device)
        if os.path.exists(os.path.join(path, HEADS_MANIFEST)):
            raise NotImplementedError(
                f"{path} holds a multi-head registry ({HEADS_MANIFEST}): "
                f"multi-head sessions are a later slice of the port "
                f"(multi-head)")
        mgr = CheckpointManager(path)
        if step is None:
            step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {path}")
        skeleton = {"w": ((config.hog.n_features,), torch.float32),
                    "b": ((), torch.float32)}
        return cls(mgr.restore(step, skeleton, dev), config, device=dev)

    def save(self, path: str, step: int = 0) -> None:
        """Persist the SVM params (the reference's atomic-commit
        checkpoint layout)."""
        from ..checkpoint.manager import CheckpointManager
        CheckpointManager(path).save(step, self.svm)

    def detect(self, image) -> Detections:
        """One frame ((H, W) gray or (H, W, 3) RGB, numpy or tensor) ->
        Detections, device-resident until decoded."""
        self._stats["frames"] += 1
        return self.detector.detect_raw(image)

    def detect_batch(self, frames) -> Detections:
        """Stacked (B, H, W[, 3]) array or frame list -> one batched
        Detections; all frames in one shape bucket (the detector's
        contract)."""
        self._stats["batches"] += 1
        return self.detector.detect_batch_raw(frames)

    def stream(self, frames, batch_size: int = 8,
               tracker: Optional[Tracker] = None) -> List[Detections]:
        """Recorded clip -> per-frame TRACKED detections.

        Detection runs through the batched device path in ``batch_size``
        chunks; the IoU tracker (config.tracker) associates in frame
        order, so ``to_list()`` entries carry track_id/hits/misses. Pass
        a Tracker to keep identities across several stream() calls.
        """
        self._stats["clips"] += 1
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

    # ------------------------------------------------------ later slices
    def serve(self, **overrides):
        raise NotImplementedError(
            "DetectionSession.serve (serve/engine.py:DetectionService): a "
            "later slice of the port (serving)")

    def cascade(self, coarse_svm=None, rng=None):
        raise NotImplementedError(
            "DetectionSession.cascade (core/cascade.py): a later slice of "
            "the port (cascade)")

    # ------------------------------------------------ per-bucket programs
    def warmup(self, shapes: Iterable[Tuple[int, ...]]) -> Dict:
        """Build ahead of traffic: each (h, w) or (B, h, w) entry runs the
        program live traffic of that shape would hit on a zero frame.
        Returns cache_stats()."""
        for s in shapes:
            s = tuple(int(v) for v in s)
            if len(s) == 2:
                self.detector.detect_raw(np.zeros(s + (3,), np.uint8))
            elif len(s) == 3:
                self.detector.detect_batch_raw(np.zeros(s + (3,), np.uint8))
            else:
                raise ValueError(
                    f"warmup shape must be (h, w) or (B, h, w), got {s}")
            self._warm.add(s)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.cache_stats()

    def cache_stats(self) -> Dict:
        """Hit/miss/size counters of this session's per-bucket programs,
        the batch-schedule autotune's sources (core/autotune_cache.py),
        the platform (repro_torch.platform.describe()), and this
        session's call and warmup bookkeeping."""
        from .. import platform
        from ..core import autotune_cache
        return {
            "frame_programs": {**self.detector.program_stats,
                               "size": len(self.detector._programs)},
            "autotune": autotune_cache.stats(),
            "platform": platform.describe(),
            "warmed": sorted(self._warm),
            "calls": dict(self._stats),
        }

    def clear_cache(self) -> None:
        """Drop this session's per-bucket programs (rebuilt at next use)."""
        self.detector._programs.clear()
        self._warm.clear()
