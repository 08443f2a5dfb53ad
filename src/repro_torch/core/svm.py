"""Linear SVM inference (eqs. 6-7) -- the inference half of
repro/core/svm.py.

The paper trains W, b offline and burns them into the co-processor's
memory; the hardware evaluates D(X) = sign(W.X + b).

  * ``svm_score`` -- scores = X @ W + b, the plain scorer (the window
    kernel is kernels/svm_matmul.py:svm_scores),
  * ``predict``   -- sign thresholding per eq. (7),
  * ``accuracy_table`` -- the paper's Table I layout.

Training (``train_svm``, ``hinge_loss``) is a later slice of the port.
"""
from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor
SVMParams = Dict[str, Tensor]   # {"w": (F,), "b": ()}


def init_svm(n_features: int, dtype=torch.float32) -> SVMParams:
    return {"w": torch.zeros((n_features,), dtype=dtype),
            "b": torch.zeros((), dtype=dtype)}


def svm_score(params: SVMParams, x: Tensor) -> Tensor:
    """D(x) = W.X + b  (eq. 6). x: (..., F) -> (...)."""
    return x @ params["w"] + params["b"]


def predict(params: SVMParams, x: Tensor) -> Tensor:
    """sign(W.X + b) > 0 -> person (eq. 7). Returns int32 {0, 1}."""
    return (svm_score(params, x) > 0).to(torch.int32)


def accuracy_table(params: SVMParams, x: Tensor,
                   y01: Tensor) -> Dict[str, float]:
    """The paper's Table I layout: per-class and total accuracy. The
    ratios are f32 divisions, as the reference's."""
    pred = predict(params, x)
    y01 = torch.as_tensor(y01, device=pred.device).to(torch.int32)
    pos = y01 == 1
    neg = y01 == 0
    tp = torch.sum((pred == 1) & pos)
    tn = torch.sum((pred == 0) & neg)
    n_pos = torch.clamp(torch.sum(pos), min=1)
    n_neg = torch.clamp(torch.sum(neg), min=1)
    return {
        "with_person_acc": float(tp / n_pos),
        "without_person_acc": float(tn / n_neg),
        "total_acc": float((tp + tn) / y01.shape[0]),
        "true_detection": int(tp + tn),
        "n": int(y01.shape[0]),
        "n_pos": int(torch.sum(pos)),
        "n_neg": int(torch.sum(neg)),
    }
