"""AdamW with f32 master weights, global-norm clipping and a warmup-cosine
schedule (port of repro/train/optimizer.py).

The state is {"step": 0-d int32 tensor, "m", "v", "master": {name: f32
tensor}}, keyed as ``CausalLM.named_parameters()`` names the model's
leaves. ``adamw_update`` follows the reference's order of operations
leaf by leaf, but updates m, v and the master weights in place (the
reference returns new trees): at qwen3-14b's width a second copy of the
f32 state would not fit beside the first. Only two f32 temporaries of
one leaf live at a time.

Decay: the reference decays leaves of ndim >= 2, and its layer leaves are
stacked on a leading layer axis, so every layer leaf -- norm scales and
the SSM's A_log, D_skip and dt_bias included -- counts as a matrix there.
The port keeps one leaf per layer, so ``decayed`` adds that axis back:
a leaf under ``layers.`` or ``enc_layers.`` is decayed at any ndim, a
top-level one (embed, lm_head, meta; not the final norms) at ndim >= 2.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Tuple

import torch

Tensor = torch.Tensor
Named = Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(step, c: OptConfig) -> Tensor:
    """Linear warmup over ``warmup_steps``, then cosine decay to
    ``min_lr_frac`` of ``lr`` at ``total_steps``; f32, on the step's
    device."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1) / max(c.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - c.warmup_steps)
                    / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = c.min_lr_frac + (1 - c.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return c.lr * warm * cos


def init_opt_state(params: Named) -> Dict[str, object]:
    """Step 0, zero m and v, and an f32 copy of each parameter."""
    first = next(iter(params.values()))
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in params.items()},
    }


def global_norm(tensors: Iterable[Tensor]) -> Tensor:
    """sqrt of the sum of every element's square, in f32, on the first
    tensor's device (the others' sums added there in order)."""
    total = None
    for g in tensors:
        sq = g.to(torch.float32).square().sum()
        total = sq if total is None else total + sq.to(total.device)
    return torch.sqrt(total)


def decayed(name: str, t: Tensor) -> bool:
    """Whether weight decay applies to leaf ``name``: ndim >= 2 of the
    reference's leaf, whose layer leaves carry a stacked layer axis."""
    stacked = name.startswith(("layers.", "enc_layers."))
    return t.dim() + int(stacked) >= 2


def adamw_update(grads: Named, state: Dict[str, object], c: OptConfig
                 ) -> Tuple[Named, Dict[str, object], Dict[str, Tensor]]:
    """One AdamW step on the f32 master weights from ``grads`` (any
    float dtype, keyed as the state): clip by the global norm, m and v
    updated, the bias-corrected step plus decay. m, v and master change
    in place; returns (master, the state with step + 1, {"grad_norm",
    "lr"}). Leaves may lie on several devices (the shards of
    train_step.py's sharded step): each is updated on its own, the step's
    scalars copied there once."""
    step = state["step"]
    gnorm = global_norm(grads.values())
    scale = torch.clamp(c.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(step, c)
    b1, b2 = c.betas
    t = (step + 1).to(torch.float32)
    corr = torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    scalars = {}
    for name, grad in grads.items():
        m, v, w = state["m"][name], state["v"][name], state["master"][name]
        if w.device not in scalars:
            scalars[w.device] = tuple(x.to(w.device)
                                      for x in (scale, lr, corr))
        scale_d, lr_d, corr_d = scalars[w.device]
        g = grad.to(torch.float32) * scale_d
        m.mul_(b1).add_((1 - b1) * g)
        g2 = (1 - b2) * g
        v.mul_(b2).add_(g2.mul_(g))
        del g, g2
        u = m * corr_d
        u.div_(torch.sqrt(v).add_(c.eps))
        if decayed(name, w):
            u.add_(c.weight_decay * w)
        w.sub_(u.mul_(lr_d))
    new_state = dict(state, step=step + 1)
    return state["master"], new_state, {"grad_norm": gnorm, "lr": lr}
