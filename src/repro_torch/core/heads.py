"""Named SVM heads -> one stacked parameter block, the port of
repro/core/heads.py.

The scoring path evaluates a linear SVM as one (BH*BW, 36) @ (36, 105)
product; K classifiers widen it to (36, 105*K), one scorer launch for
all K (kernels/svm_matmul.py). ``HeadRegistry`` is the host-side owner
of the K: NAMED heads (pedestrian, vehicle, a user's own), each a plain
``{"w": (F,), "b": ()}`` parameter dict plus an optional per-head score
threshold and free-form metadata, any subset of which stacks into the
``{"w": (K, F), "b": (K,)}`` block the detector's multi-head program
takes (core/detector.py:score_blocks). Stacking order is the caller's
class order: head k of the block IS class_id k of the Detections.

Names starting with an underscore (the cascade's "_coarse" head,
core/cascade.py) are auxiliary: they save and load with the registry
but are left out of default stacking.

Parameters are kept as host f32 numpy arrays (tensors given to ``add``
are copied off their device), so stacking is pure numpy and a session
puts the block on its own device. Persistence is the reference's layout
(checkpoint/manager.py): the parameters as one tree ``{name: {"w",
"b"}}`` under atomic step directories, and ``heads.json`` beside them
with the order, thresholds and metadata, written with the reference's
bytes, so each package loads the other's registry directories.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

HEADS_MANIFEST = "heads.json"

HostParams = Dict[str, np.ndarray]      # {"w": (F,) f32, "b": () f32}


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


@dataclasses.dataclass
class SVMHead:
    """One named classifier: params + decode-time policy."""
    name: str
    params: HostParams
    threshold: Optional[float] = None       # None -> detector default
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_features(self) -> int:
        return int(np.shape(self.params["w"])[0])


class HeadRegistry:
    """Ordered, named SVM heads with stacking and checkpoint round trip.

    Insertion order is stacking order; ``stacked()`` turns any subset
    into the detector's ``{"w": (K, F), "b": (K,)}`` block.
    """

    def __init__(self, heads: Sequence[SVMHead] = ()):
        self._heads: Dict[str, SVMHead] = {}
        for h in heads:
            self.add(h.name, h.params, h.threshold, h.metadata)

    # ------------------------------------------------------- membership
    def add(self, name: str, params, threshold: Optional[float] = None,
            metadata: Optional[Dict[str, Any]] = None,
            replace: bool = False) -> SVMHead:
        """Register a head. Params (numpy or tensors, on any device) are
        snapshotted to host f32, w flattened to (F,); re-adding an
        existing name needs ``replace=True``."""
        if not name:
            raise ValueError("head name must be non-empty")
        if name in self._heads and not replace:
            raise ValueError(f"head {name!r} already registered "
                             f"(pass replace=True to overwrite)")
        w = _host_f32(params["w"]).reshape(-1).copy()
        b = np.float32(_host_f32(params["b"]).reshape(()))
        head = SVMHead(name, {"w": w, "b": b},
                       None if threshold is None else float(threshold),
                       dict(metadata or {}))
        self._heads[name] = head
        return head

    def remove(self, name: str) -> None:
        del self._heads[name]

    def get(self, name: str) -> SVMHead:
        return self._heads[name]

    def __contains__(self, name: str) -> bool:
        return name in self._heads

    def __len__(self) -> int:
        return len(self._heads)

    def __iter__(self) -> Iterator[SVMHead]:
        return iter(self._heads.values())

    def __repr__(self) -> str:
        return f"HeadRegistry({list(self._heads)})"

    @property
    def names(self) -> Tuple[str, ...]:
        """Default stacking order: every PUBLIC head (no '_' prefix), in
        insertion order."""
        return tuple(n for n in self._heads if not n.startswith("_"))

    @property
    def n_features(self) -> Optional[int]:
        """Feature width of the default (public) stack; auxiliary heads
        may carry another HOG geometry (the cascade's coarse head does),
        so one width is required per stacking subset, not registry-wide."""
        for n, h in self._heads.items():
            if not n.startswith("_"):
                return h.n_features
        for h in self._heads.values():
            return h.n_features
        return None

    # ---------------------------------------------------------- stacking
    def stacked(self, names: Optional[Sequence[str]] = None
                ) -> Tuple[HostParams, Tuple[str, ...],
                           Tuple[Optional[float], ...]]:
        """Stack a subset of heads (default: every public one) into the
        multi-head block: ``({"w": (K, F), "b": (K,)}, names,
        thresholds)``, row k of w being head names[k]; thresholds keeps
        each head's override (None: the detector's score_threshold)."""
        names = tuple(self.names if names is None else names)
        if not names:
            raise ValueError("no heads to stack (registry empty or all "
                             "auxiliary); pass explicit names")
        missing = [n for n in names if n not in self._heads]
        if missing:
            raise KeyError(f"unknown heads {missing}; registered: "
                           f"{list(self._heads)}")
        heads = [self._heads[n] for n in names]
        if len({h.n_features for h in heads}) > 1:
            raise ValueError(
                f"stacked heads must share one HOG geometry; got feature "
                f"widths { {n: self._heads[n].n_features for n in names} }")
        svm = {"w": np.stack([h.params["w"] for h in heads]),
               "b": np.asarray([h.params["b"] for h in heads], np.float32)}
        return svm, names, tuple(h.threshold for h in heads)

    def single(self, name: str) -> HostParams:
        """One head's plain single-head ``{"w": (F,), "b": ()}`` params."""
        return dict(self._heads[name].params)

    # -------------------------------------------------------- checkpoint
    def save(self, path: str, step: int = 0) -> None:
        """Persist every head: one checkpoint step for the parameter tree
        and ``heads.json`` (order, thresholds, metadata) at the root."""
        from ..checkpoint.manager import CheckpointManager, atomic_write_json
        if not self._heads:
            raise ValueError("cannot save an empty HeadRegistry")
        tree = {n: {"w": h.params["w"], "b": h.params["b"]}
                for n, h in self._heads.items()}
        CheckpointManager(path).save(step, tree)
        manifest = {
            "version": 1,
            "heads": [{"name": h.name, "threshold": h.threshold,
                       "n_features": h.n_features,
                       "metadata": h.metadata} for h in self._heads.values()],
        }
        atomic_write_json(os.path.join(path, HEADS_MANIFEST), manifest,
                          indent=2)

    @classmethod
    def load(cls, path: str, step: Optional[int] = None) -> "HeadRegistry":
        """Restore a registry saved by either package's ``save`` (the
        latest step by default)."""
        from ..checkpoint.manager import CheckpointManager
        with open(os.path.join(path, HEADS_MANIFEST)) as f:
            manifest = json.load(f)
        mgr = CheckpointManager(path)
        if step is None:
            step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {path}")
        skeleton = {h["name"]: {"w": ((int(h["n_features"]),), torch.float32),
                                "b": ((), torch.float32)}
                    for h in manifest["heads"]}
        tree = mgr.restore(step, skeleton, "cpu")
        reg = cls()
        for h in manifest["heads"]:
            reg.add(h["name"], tree[h["name"]], h.get("threshold"),
                    h.get("metadata"))
        return reg

    @staticmethod
    def is_registry_checkpoint(path: str) -> bool:
        return os.path.exists(os.path.join(path, HEADS_MANIFEST))
