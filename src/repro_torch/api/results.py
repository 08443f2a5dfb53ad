"""Typed detection results -- the port of repro/api/results.py.

``Detections`` holds the frame program's raw outputs -- top-k ``scores``,
box-table ``index``, NMS ``keep`` mask and the threshold-candidate count
``n_valid`` -- as tensors on the detector's device, plus the static host
decode tables. Nothing is copied to the host until ``to_list()`` /
``.boxes`` / ``len()`` asks; the decode is cached. ``to_list()`` gives
the reference's dict contract (``{"box": (y0, x0, y1, x1), "score",
"scale"}``, descending score).

A leading batch axis makes a batch-of-frames result: ``d.frame(i)``
slices one frame out (no host sync), ``Detections.stack([...])`` goes the
other way, ``to_list()`` gives one list per frame and ``saturated`` one
flag per frame. ``Detections.from_list(dicts)`` wraps already-host
results (the tracking path), so ``stream()`` returns the same type;
extra keys such as ``track_id`` pass through ``to_list()`` unchanged.

Multi-class results (stacked heads) carry a CLASS axis ahead of the
top-k axis -- (K, k) per frame, (B, K, k) per batch -- and a tuple of
class names. Decoding runs each head's slots on their own (each had its
own NMS) and merges them by descending score, head order on ties; every
dict gains ``class_id`` (head index) and ``label``. ``for_class()``
slices one head back out as a single-head result.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.detector import DecodeTables


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _stack(xs):
    """Stack per-frame fields: tensors stay tensors on their device."""
    if all(isinstance(x, torch.Tensor) for x in xs):
        return torch.stack(list(xs))
    return np.stack([_host(x) for x in xs])


class Detections:
    """Results of one detection call: a single frame (1-D top-k axis) or
    a stacked batch of frames (leading batch axis), optionally with a
    class axis between the two (``classes`` names the heads). Construct
    via the session/detector, ``from_list`` or ``stack``; the raw
    constructor mirrors the program's outputs."""

    def __init__(self, scores, index, keep, n_valid, tables,
                 _lists: Optional[list] = None,
                 classes: Optional[Sequence[str]] = None):
        self._scores = scores          # (..., K) f32, top-k order, -inf pad
        self._index = index            # (..., K) rows into tables.boxes
        self._keep = keep              # (..., K) bool NMS keep mask
        self._n_valid = n_valid        # (...,)  threshold candidates
        self._tables = tables          # static: .boxes (N,4), .scales, .k
        self._lists = _lists           # cached host decode, one per frame
        self._classes = tuple(classes) if classes is not None else None

    # ------------------------------------------------------ constructors
    @classmethod
    def empty(cls, tables, classes=None) -> "Detections":
        """Empty result (frame smaller than one window)."""
        lead = () if classes is None else (len(classes),)
        return cls(np.zeros(lead + (0,), np.float32),
                   np.zeros(lead + (0,), np.int64),
                   np.zeros(lead + (0,), bool),
                   0 if classes is None else np.zeros(lead, np.int64),
                   tables, _lists=[[]], classes=classes)

    @classmethod
    def empty_batch(cls, tables, n: int, classes=None) -> "Detections":
        """Batched empty result: n frames, zero candidate slots each."""
        lead = (n,) if classes is None else (n, len(classes))
        return cls(np.zeros(lead + (0,), np.float32),
                   np.zeros(lead + (0,), np.int64),
                   np.zeros(lead + (0,), bool), np.zeros(lead, np.int64),
                   tables, _lists=[[] for _ in range(n)], classes=classes)

    @classmethod
    def from_list(cls, dets: Sequence[Dict[str, Any]]) -> "Detections":
        """Wrap host-side detection dicts (e.g. tracker output). Extra
        keys (track_id, class_id, hits, ...) are preserved by
        to_list()."""
        dets = list(dets)
        boxes = np.asarray([d["box"] for d in dets],
                           np.float32).reshape(-1, 4)
        scores = np.asarray([d["score"] for d in dets], np.float32)
        scales = np.asarray([d.get("scale", 1.0) for d in dets], np.float32)
        k = len(dets)
        return cls(scores, np.arange(k, dtype=np.int64), np.ones((k,), bool),
                   k, DecodeTables(boxes, scales, k), _lists=[dets])

    @classmethod
    def stack(cls, dets: Sequence["Detections"]) -> "Detections":
        """Stack single-frame results that share decode tables into one
        batched result (the inverse of .frame(i))."""
        dets = list(dets)
        if not dets:
            raise ValueError("stack() needs at least one Detections")
        if any(d.batched for d in dets):
            raise ValueError("stack() takes single-frame Detections")
        t0 = dets[0]._tables
        c0 = dets[0]._classes
        for d in dets[1:]:
            same = d._tables is t0 or (
                d._tables.k == t0.k
                and np.array_equal(d._tables.boxes, t0.boxes)
                and np.array_equal(d._tables.scales, t0.scales))
            if not same:
                raise ValueError("stack() needs results from the same "
                                 "compiled program (same decode tables)")
            if d._classes != c0:
                raise ValueError("stack() needs results with the same "
                                 "class names")
        nv = [d._n_valid if isinstance(d._n_valid, torch.Tensor)
              else np.asarray(d._n_valid, np.int64) for d in dets]
        return cls(_stack([d._scores for d in dets]),
                   _stack([d._index for d in dets]),
                   _stack([d._keep for d in dets]), _stack(nv), t0,
                   classes=c0)

    # -------------------------------------------------------- structure
    @property
    def classes(self) -> Optional[Tuple[str, ...]]:
        """Head names on a multi-class result, None on a single head."""
        return self._classes

    @property
    def batched(self) -> bool:
        return len(self._scores.shape) == (3 if self._classes else 2)

    @property
    def batch_size(self) -> int:
        if not self.batched:
            raise ValueError("single-frame Detections has no batch axis")
        return int(self._scores.shape[0])

    def frame(self, i: int) -> "Detections":
        """Slice one frame out of a batched result (no host sync)."""
        if not self.batched:
            raise ValueError("frame() on a single-frame Detections")
        lists = None if self._lists is None else [self._lists[i]]
        return Detections(self._scores[i], self._index[i], self._keep[i],
                          self._n_valid[i], self._tables, _lists=lists,
                          classes=self._classes)

    def for_class(self, c) -> "Detections":
        """One head (by name or index) of a multi-class result, as a
        single-head Detections (no host sync)."""
        if self._classes is None:
            raise ValueError("for_class() on a single-head Detections")
        k = self._classes.index(c) if isinstance(c, str) else int(c)
        sl = (slice(None), k) if self.batched else k
        nv = self._n_valid[sl]
        return Detections(self._scores[sl], self._index[sl], self._keep[sl],
                          nv if self.batched else int(nv), self._tables)

    def block_until_ready(self) -> "Detections":
        """Wait for the device computation backing this result."""
        if isinstance(self._scores, torch.Tensor) \
                and self._scores.device.type == "cuda":
            torch.cuda.synchronize(self._scores.device)
        return self

    # ----------------------------------------------------------- decode
    @property
    def saturated(self):
        """True when more candidates cleared the score threshold than the
        program's top-k could hold (the tail was dropped before NMS):
        bool for a frame, (B,) bool array for a batch; with a class axis
        one flag per head ((K,) / (B, K))."""
        n_valid = _host(self._n_valid)
        if self.batched or self._classes is not None:
            return n_valid > self._tables.k
        return bool(int(n_valid) > self._tables.k)

    def _decode_slots(self, top, idx, kp, n_valid, label=None) -> List[dict]:
        n_valid = int(n_valid)
        if n_valid > self._tables.k:
            who = f" (head '{label}')" if label is not None else ""
            warnings.warn(
                f"{n_valid} detection candidates cleared the threshold "
                f"but max_detections={self._tables.k}{who}; the "
                f"lowest-scoring {n_valid - self._tables.k} were dropped "
                f"before NMS (lowest kept score {top[-1]:.3f})",
                RuntimeWarning, stacklevel=5)
        kept = np.flatnonzero(kp & np.isfinite(top))
        boxes = self._tables.boxes[idx[kept]]
        scales = self._tables.scales[idx[kept]]
        return [{"box": tuple(float(v) for v in boxes[r]),
                 "score": float(top[kept[r]]),
                 "scale": float(scales[r])}
                for r in range(len(kept))]

    def _decode_frame(self, top, idx, kp, n_valid) -> List[dict]:
        if self._classes is None:
            return self._decode_slots(top, idx, kp, n_valid)
        # class axis: each head's slots decode on their own, then merge by
        # descending score; the stable sort keeps head order on ties
        merged: List[dict] = []
        for ci, name in enumerate(self._classes):
            for d in self._decode_slots(top[ci], idx[ci], kp[ci],
                                        n_valid[ci], label=name):
                d["class_id"] = ci
                d["label"] = name
                merged.append(d)
        merged.sort(key=lambda d: -d["score"])
        return merged

    def _decoded(self) -> List[List[dict]]:
        if self._lists is None:
            top, idx = _host(self._scores), _host(self._index)
            kp, nv = _host(self._keep), _host(self._n_valid)
            if self.batched:
                self._lists = [self._decode_frame(top[i], idx[i], kp[i],
                                                  nv[i])
                               for i in range(top.shape[0])]
            else:
                self._lists = [self._decode_frame(top, idx, kp, nv)]
        return self._lists

    def to_list(self):
        """The host contract: detection dicts in descending score for a
        frame, one such list per frame for a batch. Multi-class dicts also
        carry ``class_id`` and ``label``."""
        lists = self._decoded()
        return lists if self.batched else lists[0]

    # ---------------------------------------------- kept-array accessors
    def _kept(self) -> List[dict]:
        if self.batched:
            raise ValueError("array accessors are per-frame; use "
                             ".frame(i) or .to_list() on a batch")
        return self._decoded()[0]

    @property
    def boxes(self) -> np.ndarray:
        """(M, 4) kept boxes as (y0, x0, y1, x1), descending score."""
        return np.asarray([d["box"] for d in self._kept()],
                          np.float32).reshape(-1, 4)

    @property
    def scores(self) -> np.ndarray:
        return np.asarray([d["score"] for d in self._kept()], np.float32)

    @property
    def scales(self) -> np.ndarray:
        return np.asarray([d["scale"] for d in self._kept()], np.float32)

    @property
    def class_ids(self) -> np.ndarray:
        """(M,) head index per kept detection (zeros on a single head)."""
        return np.asarray([d.get("class_id", 0) for d in self._kept()],
                          np.int32)

    def __len__(self) -> int:
        """Batch: number of frames. Single frame: kept detections."""
        return self.batch_size if self.batched else len(self._kept())

    def __iter__(self) -> Iterator:
        """Batch: per-frame Detections. Single frame: detection dicts."""
        if self.batched:
            return (self.frame(i) for i in range(self.batch_size))
        return iter(self._kept())

    def __repr__(self) -> str:
        cl = f", classes={len(self._classes)}" if self._classes else ""
        if self.batched:
            return (f"Detections(batch={self.batch_size}, "
                    f"k={self._tables.k}{cl})")
        if self._lists is not None:
            return f"Detections(n={len(self._lists[0])}, decoded{cl})"
        return f"Detections(k={self._tables.k}, device-resident{cl})"
