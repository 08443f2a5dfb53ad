"""Linear SVM -- training and inference (eqs. 6-7), the port of
repro/core/svm.py.

The paper trains W, b offline and burns them into the co-processor's
memory; the hardware evaluates D(X) = sign(W.X + b). Both halves run
here:

  * ``train_svm``  -- primal hinge loss + L2, Pegasos-style SGD
    (lr_t = min(1 / (lambda * t), 1)), in two parts: ``train_schedule``
    draws every step's minibatch indices at once from a CPU
    ``torch.Generator`` seeded with ``cfg.seed`` (so the card and the CPU
    train on the same schedule), and ``pegasos`` runs the steps on the
    features' device with no host sync inside the loop,
  * ``hinge_loss`` -- the objective,
  * ``svm_score``  -- scores = X @ W + b, the plain scorer (the window
    kernel is kernels/svm_matmul.py:svm_scores),
  * ``predict``    -- sign thresholding per eq. (7),
  * ``accuracy_table`` -- the paper's Table I layout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
SVMParams = Dict[str, Tensor]   # {"w": (F,), "b": ()}


def init_svm(n_features: int, dtype=torch.float32, device=None) -> SVMParams:
    return {"w": torch.zeros((n_features,), dtype=dtype, device=device),
            "b": torch.zeros((), dtype=dtype, device=device)}


def svm_score(params: SVMParams, x: Tensor) -> Tensor:
    """D(x) = W.X + b  (eq. 6). x: (..., F) -> (...)."""
    return x @ params["w"] + params["b"]


def predict(params: SVMParams, x: Tensor) -> Tensor:
    """sign(W.X + b) > 0 -> person (eq. 7). Returns int32 {0, 1}."""
    return (svm_score(params, x) > 0).to(torch.int32)


def _class_weights(y_pm1: Tensor, neg_weight: float) -> Tensor:
    return torch.where(y_pm1 < 0, torch.full_like(y_pm1, neg_weight),
                       torch.ones_like(y_pm1))


def hinge_loss(params: SVMParams, x: Tensor, y_pm1: Tensor,
               lam: float, neg_weight: float = 1.0) -> Tensor:
    """lambda/2 ||w||^2 + weighted mean(max(0, 1 - y * D(x))), y in {-1,+1}.

    ``neg_weight`` re-weights the negative class -- used to counter the
    paper's 4202/2795 train imbalance (class-weighted C-SVM).
    """
    margins = y_pm1 * svm_score(params, x)
    wt = _class_weights(y_pm1, neg_weight)
    data = torch.sum(wt * torch.clamp_min(1.0 - margins, 0.0)) / torch.sum(wt)
    reg = float(np.float32(0.5 * lam)) * torch.sum(params["w"] * params["w"])
    return data + reg


def hinge_active(v: Tensor) -> Tensor:
    """d max(0, v) / dv as the reference differentiates it (jax.grad of
    jnp.maximum): 1 where v > 0, 0.5 at the tie v == 0, 0 below."""
    return (v > 0).to(v.dtype) + 0.5 * (v == 0).to(v.dtype)


@dataclasses.dataclass(frozen=True)
class SVMTrainConfig:
    steps: int = 2000
    batch: int = 256
    lam: float = 1e-4          # L2 strength (Pegasos lambda)
    seed: int = 0
    pegasos_lr: bool = True    # lr_t = 1/(lam * t); else constant 0.1
    neg_weight: float = 1.0    # class weight for negatives (imbalance fix)


def train_schedule(n: int, cfg: SVMTrainConfig = SVMTrainConfig()) -> Tensor:
    """(steps, batch) int64 minibatch indices into n samples, drawn on the
    CPU from a generator seeded with ``cfg.seed``: the same on every
    device."""
    gen = torch.Generator().manual_seed(int(cfg.seed))
    return torch.randint(0, int(n), (cfg.steps, cfg.batch), generator=gen)


def learning_rates(cfg: SVMTrainConfig) -> np.ndarray:
    """(steps,) f32 step sizes: min(1 / (lam * (t + 1)), 1) in f32, as the
    reference computes them, or 0.1 without the Pegasos schedule."""
    if not cfg.pegasos_lr:
        return np.full(cfg.steps, 0.1, np.float32)
    t1 = np.arange(cfg.steps, dtype=np.float32) + np.float32(1.0)
    lr = np.float32(1.0) / (np.float32(cfg.lam) * t1)
    return np.minimum(lr, np.float32(1.0))


def pegasos_step(w: Tensor, b: Tensor, xb: Tensor, yb: Tensor, lr: Tensor,
                 cfg: SVMTrainConfig) -> Tuple[Tensor, Tensor, Tensor]:
    """One step on the minibatch (xb (batch, F), yb (batch,) in {-1, +1}):
    the closed-form gradient of the weighted mean hinge plus lam * w
    (the tie passes 0.5, ``hinge_active``), then w - lr * g. Returns the
    new (w, b) and hinge_loss(new, xb, yb, lam) -- without neg_weight, as
    the reference's loss curve."""
    wt = _class_weights(yb, cfg.neg_weight)
    v = 1.0 - yb * (xb @ w + b)
    coef = wt * (1.0 / torch.sum(wt))
    ct = -(coef * hinge_active(v)) * yb           # d data / d score
    reg = float(np.float32(0.5 * cfg.lam))
    g_w = ct @ xb + 2.0 * (reg * w)
    g_b = torch.sum(ct)
    w = w - lr * g_w
    b = b - lr * g_b
    return w, b, hinge_loss({"w": w, "b": b}, xb, yb, cfg.lam)


def pegasos(x: Tensor, y_pm1: Tensor, idx: Tensor,
            cfg: SVMTrainConfig = SVMTrainConfig()
            ) -> Tuple[SVMParams, Tensor]:
    """The step loop over a given (steps, batch) index schedule, on x's
    device. Returns (params, losses (steps,)); nothing is read back to
    the host inside the loop."""
    dev = x.device
    x = x.to(torch.float32)
    y_pm1 = y_pm1.to(device=dev, dtype=torch.float32)
    idx = idx.to(dev)
    lrs = torch.from_numpy(learning_rates(cfg)).to(dev)
    params = init_svm(x.shape[1], device=dev)
    w, b = params["w"], params["b"]
    losses = torch.empty(len(idx), dtype=torch.float32, device=dev)
    for t in range(len(idx)):
        i = idx[t]
        w, b, losses[t] = pegasos_step(w, b, x[i], y_pm1[i], lrs[t], cfg)
    return {"w": w, "b": b}, losses


def train_svm(x: Tensor, y01: Tensor,
              cfg: SVMTrainConfig = SVMTrainConfig()
              ) -> Tuple[SVMParams, Tensor]:
    """Train on features x (N, F), labels y01 (N,) in {0, 1}, on x's
    device. Returns (params, loss curve (steps,))."""
    y = torch.as_tensor(y01).to(device=x.device, dtype=torch.float32)
    return pegasos(x, y * 2.0 - 1.0, train_schedule(x.shape[0], cfg), cfg)


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
