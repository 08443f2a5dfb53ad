"""GPipe-style pipeline parallelism over a grid axis (port of
repro/train/pipeline.py; the multi-pod "pod" / "pipe" axis, where only
stage boundaries -- one (B_mb, S, D) activation a tick -- cross it).

``gpipe_apply`` splits a list of per-layer parameter sets into P
contiguous stages, each on the device of its stage along ``axis``, and
runs M microbatches through the classic (M + P - 1)-tick schedule: at
tick t stage s runs microbatch t - s, and its output moves to stage s + 1
by a copy (the reference's ppermute). A stage idle in the bubble runs
nothing (the reference's runs on a placeholder whose result it masks
away). Autograd differentiates straight through it -- the transpose of
each copy is the reverse hop -- so GPipe's backward schedule comes from
autograd. Bubble fraction = (P - 1) / (M + P - 1) (``bubble_fraction``);
stages must be uniform (n_layers % P == 0).
"""
from __future__ import annotations

import types
from typing import Any, Callable, Sequence

import torch

from ..launch.mesh import DeviceGrid

Tensor = torch.Tensor


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _to(tree: Any, device) -> Any:
    """A layer's parameters on ``device``, differentiably: tensors copied
    (none where they are there already), dicts, lists and modules (as
    namespaces of their parameters and children) walked."""
    if isinstance(tree, Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return types.SimpleNamespace(
            **{n: _to(t, device) for n, t in tree._parameters.items()},
            **{n: _to(c, device) for n, c in tree.named_children()})
    return tree


def stage_devices(grid: DeviceGrid, axis: str):
    """The device of each stage: the grid's devices along ``axis``, every
    other axis at index 0."""
    k = grid.axis_names.index(axis)
    return [grid.device(tuple(s if j == k else 0
                              for j in range(len(grid.shape))))
            for s in range(grid.shape[k])]


def gpipe_apply(layer_fn: Callable[[Any, Tensor], Tensor],
                layers_params: Sequence[Any], x_micro: Tensor,
                grid: DeviceGrid, axis: str = "pipe") -> Tensor:
    """Run a layer stack as a GPipe pipeline.

    layer_fn(lp, x) -> x applies ONE layer (lp: that layer's parameters,
    an entry of ``layers_params``, L of them, L % P == 0). x_micro: (M,
    B_mb, ...) microbatched inputs. Returns the (M, B_mb, ...) outputs of
    the last stage, on x_micro's device.
    """
    devs = stage_devices(grid, axis)
    n_stages = len(devs)
    L = len(layers_params)
    assert L % n_stages == 0, (L, n_stages)
    per = L // n_stages
    stages = [[_to(lp, devs[s]) for lp in layers_params[s * per:
                                                        (s + 1) * per]]
              for s in range(n_stages)]
    M = x_micro.shape[0]
    outs = [None] * M
    buf = [None] * n_stages            # the activation entering each stage
    for t in range(M + n_stages - 1):
        nxt = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < M:
                continue
            y = x_micro[m].to(devs[0]) if s == 0 else buf[s]
            for lp in stages[s]:
                y = layer_fn(lp, y)
            if s == n_stages - 1:
                outs[m] = y.to(x_micro.device)
            else:
                nxt[s + 1] = y.to(devs[s + 1])
        buf = nxt
    return torch.stack(outs)
