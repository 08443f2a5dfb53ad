"""Typed detection results of one frame -- the port of
repro/api/results.py, single-frame part.

``Detections`` holds the frame program's raw outputs -- top-k ``scores``,
box-table ``index``, NMS ``keep`` mask and the threshold-candidate count
``n_valid`` -- as tensors on the detector's device, plus the static host
decode tables. Nothing is copied to the host until ``to_list()`` /
``.boxes`` / ``len()`` asks; the decode is cached. ``to_list()`` gives
the reference's dict contract (``{"box": (y0, x0, y1, x1), "score",
"scale"}``, descending score).

Batched results (``frame``, ``stack``, ``empty_batch``) and class axes
(``for_class``) belong to the batched and multi-head paths, later slices.
"""
from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Detections:
    """Results of one single-frame detection call."""

    def __init__(self, scores, index, keep, n_valid, tables,
                 _lists: Optional[list] = None):
        self._scores = scores          # (K,) f32, top-k order, -inf pad
        self._index = index            # (K,) rows into tables.boxes
        self._keep = keep              # (K,) bool NMS keep mask
        self._n_valid = n_valid        # ()  threshold candidates
        self._tables = tables          # static: .boxes (N,4), .scales, .k
        self._lists = _lists           # cached host decode

    @classmethod
    def empty(cls, tables) -> "Detections":
        """Empty result (frame smaller than one window)."""
        return cls(np.zeros((0,), np.float32), np.zeros((0,), np.int64),
                   np.zeros((0,), bool), 0, tables, _lists=[[]])

    def block_until_ready(self) -> "Detections":
        """Wait for the device computation backing this result."""
        if isinstance(self._scores, torch.Tensor) \
                and self._scores.device.type == "cuda":
            torch.cuda.synchronize(self._scores.device)
        return self

    @property
    def saturated(self) -> bool:
        """True when more candidates cleared the score threshold than the
        program's top-k could hold (the tail was dropped before NMS)."""
        return int(_host(self._n_valid)) > self._tables.k

    def _decoded(self) -> List[dict]:
        if self._lists is None:
            top = _host(self._scores)
            idx = _host(self._index)
            kp = _host(self._keep)
            n_valid = int(_host(self._n_valid))
            if n_valid > self._tables.k:
                warnings.warn(
                    f"{n_valid} detection candidates cleared the threshold "
                    f"but max_detections={self._tables.k}; the "
                    f"lowest-scoring {n_valid - self._tables.k} were "
                    f"dropped before NMS (lowest kept score {top[-1]:.3f})",
                    RuntimeWarning, stacklevel=3)
            kept = np.flatnonzero(kp & np.isfinite(top))
            boxes = self._tables.boxes[idx[kept]]
            scales = self._tables.scales[idx[kept]]
            self._lists = [[{"box": tuple(float(v) for v in boxes[r]),
                             "score": float(top[kept[r]]),
                             "scale": float(scales[r])}
                            for r in range(len(kept))]]
        return self._lists[0]

    def to_list(self) -> List[dict]:
        """The host contract: detection dicts in descending score."""
        return self._decoded()

    @property
    def boxes(self) -> np.ndarray:
        """(M, 4) kept boxes as (y0, x0, y1, x1), descending score."""
        return np.asarray([d["box"] for d in self._decoded()],
                          np.float32).reshape(-1, 4)

    @property
    def scores(self) -> np.ndarray:
        return np.asarray([d["score"] for d in self._decoded()], np.float32)

    @property
    def scales(self) -> np.ndarray:
        return np.asarray([d["scale"] for d in self._decoded()], np.float32)

    def __len__(self) -> int:
        return len(self._decoded())

    def __repr__(self) -> str:
        if self._lists is not None:
            return f"Detections(n={len(self._lists[0])}, decoded)"
        return f"Detections(k={self._tables.k}, device-resident)"
