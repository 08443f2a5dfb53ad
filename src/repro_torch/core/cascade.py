"""Degraded entry points of the detector -- the port of the
``reduced_detector`` rung of repro/core/cascade.py.

The rest of the reference module (``CascadeConfig``, ``plan_regions``,
the coarse head, ``CascadeDetector`` and its ``detect_degraded``, which
back the service's "cascade" and "coarse" ladder rungs) is a later slice
of the port (cascade).
"""
from __future__ import annotations

import dataclasses

from .detector import FrameDetector


def reduced_detector(det: FrameDetector, n_scales: int = 1
                     ) -> FrameDetector:
    """Degradation-ladder rung "reduced" (serve/resilience.py): the SAME
    head and numerics on a truncated pyramid -- only the first
    `n_scales` scales are swept, so far-away (small) pedestrians are
    the quality traded for latency under overload. Shares the svm
    params and the device, so recovered full-pipeline results are
    byte-identical to an undegraded run. (The reference also passes
    the multi-head class labels; the port's FrameDetector has none until
    the multi-head slice.)"""
    cfg = dataclasses.replace(det.cfg,
                              scales=det.cfg.scales[:max(1, int(n_scales))])
    return FrameDetector(det.svm, cfg, device=det.device)
