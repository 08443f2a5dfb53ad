"""Training steps (port of repro/train/train_step.py): the plain step and
the data-parallel step with optional int8 gradient compression.

The state is {"params": a trainable ``CausalLM``, "opt": the optimizer
state (train/optimizer.py), keyed by parameter name}, plus "residual"
(one dict of f32 residuals a data-parallel shard) for the DDP step.
Steps update it in place and return it with the metrics {"loss",
"grad_norm", "lr"} as 0-d tensors on the card (nothing waits for the
device).

  * ``make_train_step(cfg, opt, microbatches=1)`` -- the reference's step
    with ``ctx=None``: loss and gradients by autograd through
    ``models.model.loss_fn`` (each layer recomputed in the backward),
    optionally summed in f32 over microbatches and averaged, then one
    AdamW update of the f32 master weights, copied back into the
    parameters in their dtype.
  * ``make_ddp_train_step(cfg, opt, compress=True)`` -- the reference's
    shard_map trainer over the port's data grid
    (``launch/mesh.py:visible_devices``): the batch split over the grid's
    devices, each shard's gradients, their mean (plain in f32, or
    int8-compressed with each shard's residual), the mean loss, then one
    AdamW update. The shards run one after another on one card, the
    grid's logical devices (REPRO_TEST_DEVICES); a grid of several cards
    is refused: replicas across cards come with the LM mesh.

The reference's GSPMD pieces (``jit_train_step``, ``state_shardings``,
``constrain_grads``) and its pipeline trainer belong to the LM mesh.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ..launch.mesh import visible_devices
from ..models.configs import ModelConfig
from ..models.model import CausalLM, init_params, loss_fn, trainable
from .grad_compress import compress_tree_mean, init_residuals
from .optimizer import OptConfig, adamw_update, init_opt_state

Tensor = torch.Tensor
State = Dict[str, object]
Step = Callable[[State, Dict[str, object]], Tuple[State, Dict[str, Tensor]]]


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device=None) -> State:
    """Random parameters (``init_params``) made trainable, and a fresh
    optimizer state."""
    params = trainable(init_params(cfg, generator, device))
    return {"params": params,
            "opt": init_opt_state(dict(params.named_parameters()))}


def init_ddp_state(cfg: ModelConfig, generator: torch.Generator,
                   device=None) -> State:
    """``init_train_state`` plus zero residuals for each shard of the data
    grid on ``device``."""
    state = init_train_state(cfg, generator, device)
    named = dict(state["params"].named_parameters())
    shards = len(ddp_devices(state["params"].device))
    state["residual"] = [init_residuals(named) for _ in range(shards)]
    return state


def ddp_devices(device) -> tuple:
    """The data grid of the DDP step: the visible devices, which must be
    one card (or the CPU) repeated as logical devices."""
    devs = visible_devices(device)
    if len(set(devs)) > 1:
        raise ValueError(f"make_ddp_train_step runs its shards on one "
                         f"device; the grid holds {len(set(devs))} cards "
                         f"(a step across cards comes with the LM mesh)")
    return devs


def _on_device(batch: Dict[str, object], device) -> Dict[str, object]:
    """The batch's arrays as tensors on ``device``; ``positions`` stays
    where it is (a host copy decides the flash route)."""
    return {k: v if k == "positions" else torch.as_tensor(v).to(device)
            for k, v in batch.items()}


def _split(batch: Dict[str, object], n: int) -> List[Dict[str, object]]:
    """The batch cut into n equal runs of rows (the reference's reshape to
    (n, -1, ...))."""
    rows = len(batch["tokens"])
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split into {n}")
    b = rows // n
    return [{k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            for i in range(n)]


def _grads(params: CausalLM, named: Dict[str, Tensor],
           batch: Dict[str, object], cfg: ModelConfig
           ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The loss and every parameter's gradient (zeros where the family
    never reads a leaf, as jax.grad gives), the .grad fields cleared."""
    loss = loss_fn(params, batch, cfg)
    loss.backward()
    grads = {}
    for n, p in named.items():
        grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return loss.detach(), grads


def _update(named: Dict[str, Tensor], grads: Dict[str, Tensor],
            opt_state: State, opt: OptConfig):
    """AdamW on the master weights, then each parameter set to its master
    in its own dtype."""
    master, opt_state, metrics = adamw_update(grads, opt_state, opt)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(master[n])
    return opt_state, metrics


def make_train_step(cfg: ModelConfig, opt: OptConfig,
                    microbatches: int = 1) -> Step:
    """train_step(state, batch) -> (state, metrics); batch: tokens and
    labels (B, S) [+ positions, enc_input], numpy or tensors."""

    def step(state: State, batch: Dict[str, object]):
        params = state["params"]
        named = dict(params.named_parameters())
        batch = _on_device(batch, params.device)
        if microbatches > 1:
            acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for n, p in named.items()}
            lsum = 0.0
            for piece in _split(batch, microbatches):
                loss, grads = _grads(params, named, piece, cfg)
                for n, a in acc.items():
                    a.add_(grads[n])
                del grads
                lsum = lsum + loss
            loss = lsum / microbatches
            grads = {n: a.div_(microbatches) for n, a in acc.items()}
        else:
            loss, grads = _grads(params, named, batch, cfg)
        opt_state, metrics = _update(named, grads, state["opt"], opt)
        return {"params": params, "opt": opt_state}, dict(metrics, loss=loss)

    return step


def make_ddp_train_step(cfg: ModelConfig, opt: OptConfig,
                        compress: bool = True) -> Step:
    """ddp_step(state, batch) -> (state, metrics) over the data grid of
    the parameters' device; ``state`` from ``init_ddp_state``."""

    def step(state: State, batch: Dict[str, object]):
        params = state["params"]
        n = len(ddp_devices(params.device))
        if len(state["residual"]) != n:
            raise ValueError(f"the state holds {len(state['residual'])} "
                             f"shards' residuals, the grid {n} devices")
        named = dict(params.named_parameters())
        losses, shard_grads = [], []
        for piece in _split(_on_device(batch, params.device), n):
            loss, grads = _grads(params, named, piece, cfg)
            losses.append(loss)
            shard_grads.append(grads)
        loss = sum(losses) / n
        if compress:
            grads, residual = compress_tree_mean(shard_grads,
                                                 state["residual"])
        else:
            grads = {k: (sum(g[k].to(torch.float32) for g in shard_grads)
                         / n).to(shard_grads[0][k].dtype) for k in named}
            residual = state["residual"]
        del shard_grads
        opt_state, metrics = _update(named, grads, state["opt"], opt)
        return ({"params": params, "opt": opt_state, "residual": residual},
                dict(metrics, loss=loss))

    return step


def state_tree(state: State) -> Dict[str, object]:
    """The state as a tree of tensors (parameters by name), as
    checkpoint/manager.py saves it."""
    tree = {"params": {n: p.detach()
                       for n, p in state["params"].named_parameters()},
            "opt": state["opt"]}
    if "residual" in state:
        tree["residual"] = state["residual"]
    return tree


def load_state_tree(state: State, tree: Dict[str, object]) -> State:
    """``state`` with the values of ``tree`` (as ``state_tree`` gives
    it): parameters copied in place, the rest taken over."""
    with torch.no_grad():
        for n, p in state["params"].named_parameters():
            p.copy_(tree["params"][n])
    state["opt"] = tree["opt"]
    if "residual" in tree:
        state["residual"] = tree["residual"]
    return state
