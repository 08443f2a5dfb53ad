"""Training steps (port of repro/train/train_step.py): the plain step,
the sharded (ZeRO-3) step over a device grid, and the data-parallel step
with optional int8 gradient compression.

The plain state is {"params": a trainable ``CausalLM``, "opt": the
optimizer state (train/optimizer.py), keyed by parameter name}, plus,
for the DDP step, "residual" (one dict of f32 residuals a data-parallel
shard) and, on several cards, "replicas". Steps update it in place and
return it with the metrics {"loss", "grad_norm", "lr"} as 0-d tensors on
the card (nothing waits for the device).

  * ``make_train_step(cfg, opt, microbatches=1)`` -- the reference's step
    with ``ctx=None``: loss and gradients by autograd through
    ``models.model.loss_fn`` (each layer recomputed in the backward),
    optionally summed in f32 over microbatches and averaged, then one
    AdamW update of the f32 master weights, copied back into the
    parameters in their dtype.
  * ``jit_train_step(cfg, opt, grid, profile, microbatches=1)`` -- the
    reference's GSPMD trainer as ZeRO-3 over the grid's dp axes, on a
    state held as the shards ``state_shardings`` lays out
    (``init_train_state(..., shardings=)`` makes it per shard,
    ``shard_state`` from a plain state, ``gather_state`` takes it back).
    The dp rows of the batch run one after another, each on the path
    ``models.model.train_path`` names. "model" (every family on a grid
    whose "model" axis is larger than 1; the reference's batch at P(dp,
    "model")): the row's sequence (and whisper's frames; hymba's meta
    tokens first) cut over its devices, each layer gathered whole onto
    every device of the row (its copies' gradients summed into each
    piece in model-index order), K and V gathered and each chunk's
    queries attending at its offset, the SSD's state handed on across
    the chunks (``models.model.model_nll_sum``). "rows" (a grid whose
    "model" axis is 1): the row on its own device (the
    row's first), each layer gathering its parameters there as it runs
    and again in the recomputed backward (models/sharded.py:
    ``row_model``), the MoE on the row's devices through the EP paths.
    Either way the loss's numerator is summed over (row, chunk) in f32 in
    grid order and divided by the global count (the global mean, however
    the ignored labels fall); each piece's gradient is its own
    (``_own_grad``: no device keeps a whole layer's gradient past its
    backward) and is summed over rows in f32 in row order; AdamW runs
    shard by shard on each shard's device and the parameters' shards are
    copied back in their dtype. The reference's ``donate``,
    ``state_shape`` and ``batch_shape`` have no counterpart: nothing is
    compiled ahead, and the state is updated in place.
  * ``make_ddp_train_step(cfg, opt, grid=None, compress=True)`` -- the
    reference's shard_map trainer over a grid of dp axes (by default the
    ("data",) grid of the visible devices, ``ddp_grid``): the batch split
    over the grid row-major, each shard's gradients, their mean --
    int8-compressed with each shard's residual over the innermost dp axis
    (or plain), then a plain mean over the outer ones -- the mean loss,
    then one AdamW update. On logical devices of one card the shards run
    one after another on one replica. On several cards each card holds a
    replica (``init_ddp_state``): plain, the gradients are gathered to the
    first card and averaged there in shard order; compressed, each card
    quantizes its own gradient and every card averages all the int8
    payloads and scales in shard order. Either way every replica takes
    the same update from the same numbers.

The reference's ``constrain_grads`` pins gradients to the parameters'
layout, which the sharded step has by construction.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..launch.mesh import DeviceGrid, grid_of, visible_devices
from ..models.configs import ModelConfig
from ..models.model import (CausalLM, init_params, loss_fn, model_nll_sum,
                            nll_sum, param_shapes, train_path,
                            trainable)
from ..models.sharded import (ModelRow, ShardedLM, row_model, row_plans,
                              shard_leaf)
from ..sharding.rules import (PROFILES, Profile, Sharding, device_bytes,
                              dp_axes, make_ctx, param_shardings)
from .grad_compress import init_residuals, mean_of_payloads, quantize_shards
from .optimizer import OptConfig, adamw_update, init_opt_state

Tensor = torch.Tensor
State = Dict[str, object]
Step = Callable[[State, Dict[str, object]], Tuple[State, Dict[str, Tensor]]]


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device=None, shardings=None) -> State:
    """Random parameters (``init_params``) made trainable, and a fresh
    optimizer state. ``shardings`` (``state_shardings``): the state the
    sharded step holds, made per shard -- equal, bit for bit, to
    ``shard_state(init_train_state(...), shardings)``: each leaf drawn on
    ``device`` and cut into its pieces (``init_params(...,
    shardings=)``), the f32 master from each piece, m and v zeros a
    piece, the step on the grid's first device."""
    if shardings is not None:
        return _sharded_init(cfg, generator, device, shardings)
    params = trainable(init_params(cfg, generator, device))
    return {"params": params,
            "opt": init_opt_state(dict(params.named_parameters()))}


def _sharded_init(cfg: ModelConfig, generator: torch.Generator, device,
                  shardings: Dict[str, object]) -> State:
    model = init_params(cfg, generator, device, shardings["params"])
    opt: Dict[str, object] = {"step": torch.zeros(
        (), dtype=torch.int32, device=model.grid.flat[0])}
    for k in ("m", "v", "master"):
        opt[k] = {n: _per_piece(pieces, k) for n, pieces in
                  model.pieces.items()}
    return {"params": model.pieces, "opt": opt}


def _per_piece(pieces: List[Tensor], kind: str) -> List[Tensor]:
    """An f32 tensor for each distinct piece (shared where the pieces
    are): its copy for "master", zeros for "m" and "v"."""
    made: Dict[int, Tensor] = {}
    for p in pieces:
        if id(p) not in made:
            made[id(p)] = (p.to(torch.float32, copy=True) if kind == "master"
                           else torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device))
    return [made[id(p)] for p in pieces]


def init_ddp_state(cfg: ModelConfig, generator: torch.Generator,
                   device=None, grid: Optional[DeviceGrid] = None) -> State:
    """``init_train_state`` plus zero residuals for each shard of the
    data grid (``ddp_grid(device)`` by default), each on its shard's
    device, and, on several cards, a copy of the parameters and optimizer
    state on each ("replicas", the first being the state's own)."""
    state = init_train_state(cfg, generator, device)
    grid = ddp_grid(state["params"].device) if grid is None else grid
    named = dict(state["params"].named_parameters())
    state["residual"] = [
        {n: r.to(d) for n, r in init_residuals(named).items()}
        for d in grid.flat]
    devs = list(dict.fromkeys(grid.flat))
    if len(devs) > 1:
        state["replicas"] = [{"params": state["params"],
                              "opt": state["opt"]}] + [
            _replica(state, d) for d in devs[1:]]
    return state


def _replica(state: State, device) -> State:
    params = trainable(CausalLM(state["params"].cfg, _module_tree(
        state["params"], device)))
    opt = {"step": state["opt"]["step"].to(device),
           **{k: {n: t.to(device, copy=True) for n, t in
                  state["opt"][k].items()} for k in ("m", "v", "master")}}
    return {"params": params, "opt": opt}


def _module_tree(module, device):
    """A CausalLM's leaves as the tree ``CausalLM`` takes, copied to
    ``device``."""
    tree = {n: t.detach().to(device, copy=True)
            for n, t in module._parameters.items()}
    for n, child in module.named_children():
        if isinstance(child, torch.nn.ModuleList):
            tree[n] = [_module_tree(c, device) for c in child]
        else:
            tree[n] = _module_tree(child, device)
    return tree


def ddp_replicas(state: State) -> List[State]:
    """The DDP state's replicas: one a distinct device of the grid."""
    return state.get("replicas") or [state]


def ddp_grid(device) -> DeviceGrid:
    """The ("data",) grid of the visible devices, the DDP step's default
    (the reference's ``jax.make_mesh((n,), ("data",))``)."""
    devs = visible_devices(device)
    return grid_of(devs, (len(devs),), ("data",))


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


# ------------------------------------------------------ sharded (ZeRO-3)

def state_shardings(grid: DeviceGrid, state, cfg: ModelConfig
                    ) -> Dict[str, object]:
    """The ``Sharding`` of every leaf of the train state, fitted leaf by
    leaf: {"params": {name: Sharding}, "opt": {"step": replicated, "m",
    "v", "master": as the params}}. ``state``: a plain state, or
    {"params": {name: shape}} (``models.model.param_shapes``), so a plan
    needs nothing allocated."""
    sh = param_shardings(grid, state["params"], cfg)
    return {"params": sh, "opt": {"step": Sharding(grid, ()), "m": sh,
                                  "v": sh, "master": sh}}


def state_device_bytes(grid: DeviceGrid, cfg: ModelConfig,
                       shapes: Optional[Dict[str, Tensor]] = None
                       ) -> List[int]:
    """The bytes of the train state (parameters in their dtype; f32 m, v
    and master; the int32 step) each grid device holds under
    ``state_shardings``, from the config alone (or its parameters'
    ``shapes``, ``models.model.param_shapes``, where given)."""
    shapes = param_shapes(cfg) if shapes is None else shapes
    f32 = {n: (tuple(t.shape), torch.float32) for n, t in shapes.items()}
    return device_bytes(
        state_shardings(grid, {"params": shapes}, cfg),
        {"params": shapes, "opt": {"step": ((), torch.int32), "m": f32,
                                   "v": f32, "master": f32}})


def shard_state(state: State, shardings: Dict[str, object]) -> State:
    """A plain train state as the sharded step holds it: {"params":
    {name: pieces}, "opt": {"step", "m", "v", "master": {name:
    pieces}}}, each piece on its grid device (a view of the plain leaf
    where the device is the leaf's)."""
    sp = shardings["params"]
    named = dict(state["params"].named_parameters())
    o = state["opt"]
    grid = next(iter(sp.values())).grid
    return {"params": {n: shard_leaf(sp[n], t) for n, t in named.items()},
            "opt": {"step": o["step"].to(grid.flat[0]),
                    **{k: {n: shard_leaf(shardings["opt"][k][n], t)
                           for n, t in o[k].items()}
                       for k in ("m", "v", "master")}}}


def gather_state(sharded: State, shardings: Dict[str, object],
                 device=None) -> Dict[str, object]:
    """The sharded state's leaves whole, on ``device`` (each leaf's first
    piece's by default): {"params": {name: tensor}, "opt": {...}}."""
    def whole(tree, sh):
        return {n: sh[n].gather(p, device) for n, p in tree.items()}
    o = sharded["opt"]
    return {"params": whole(sharded["params"], shardings["params"]),
            "opt": {"step": o["step"],
                    **{k: whole(o[k], shardings["opt"][k])
                       for k in ("m", "v", "master")}}}


def jit_train_step(cfg: ModelConfig, opt: OptConfig, grid: DeviceGrid,
                   profile: Profile = PROFILES["baseline"],
                   microbatches: int = 1) -> Step:
    """step(sharded_state, batch) -> (sharded_state, metrics): ZeRO-3 over
    the grid's dp axes on a state from ``shard_state`` with
    ``state_shardings(grid, ...)``; the batch (tokens, labels (B, S) [+
    positions, enc_input]) split into ``microbatches`` runs of rows, each
    over the dp rows. ``step.grads(state, batch)`` -> (loss, {name: f32
    gradient pieces}) is its first half, the gradient as the update sees
    it. Each call takes the path ``models.model.train_path`` names."""
    sh = param_shardings(grid, param_shapes(cfg), cfg)
    # a row reads each block from its own devices where they hold it
    ctx = make_ctx(grid, profile=profile)
    plans = row_plans(ctx)
    home = grid.flat[0]

    def grads(state: State, batch: Dict[str, object]):
        params = state["params"]
        taken = train_path(params, cfg, ctx)
        owner = {n: sh[n].owners(p[0].dim()) for n, p in params.items()}
        acc = {n: {i: torch.zeros(p[i].shape, dtype=torch.float32,
                                  device=p[i].device)
                   for i in sorted(set(owner[n]))}
               for n, p in params.items()}
        lsum = None
        for mb in _split(batch, microbatches):
            count = torch.clamp((torch.as_tensor(mb["labels"]) >= 0).sum(),
                                min=1)
            nll_tot = None
            for plan, part in zip(plans, _split(mb, len(plans))):
                dev = plan.device
                handles = {n: [_own_grad(q.detach().requires_grad_())
                               for q in p] for n, p in params.items()}
                if taken == "model":
                    model = ModelRow(ShardedLM(cfg, sh, handles), plan)
                    nll = model_nll_sum(model, part, cfg, ctx)
                else:
                    model = row_model(cfg, handles, sh, plan)
                    nll, _ = nll_sum(model, _on_device(part, dev), cfg,
                                     plan.ctx)
                (nll / count.to(dev)).backward()
                nll = nll.detach().to(home)
                nll_tot = nll if nll_tot is None else nll_tot + nll
                for n, hs in handles.items():
                    for i, h in enumerate(hs):
                        if h.grad is not None:
                            a = acc[n][owner[n][i]]
                            a.add_(h.grad.to(a.device, torch.float32))
                del handles, model
            loss = nll_tot / count.to(home)
            lsum = loss if lsum is None else lsum + loss
        if microbatches > 1:
            for by_block in acc.values():
                for a in by_block.values():
                    a.div_(microbatches)
            lsum = lsum / microbatches
        return lsum, acc

    def step(state: State, batch: Dict[str, object]):
        loss, g = grads(state, batch)
        o = state["opt"]
        key, flat_g, m, v, w = {}, {}, {}, {}, {}
        for n, by_block in g.items():
            for i, a in by_block.items():
                k = f"{n}@{i}"
                key[k] = (n, i)
                flat_g[k] = a
                m[k], v[k], w[k] = (o["m"][n][i], o["v"][n][i],
                                    o["master"][n][i])
        _, new, metrics = adamw_update(
            flat_g, {"step": o["step"], "m": m, "v": v, "master": w}, opt)
        del flat_g, g
        with torch.no_grad():
            for k, (n, i) in key.items():
                state["params"][n][i].copy_(w[k])
            for n, p in state["params"].items():
                _replicate(sh[n], [p] + [o[t][n] for t in
                                         ("m", "v", "master")])
        o["step"] = new["step"]
        return state, dict(metrics, loss=loss)

    step.grads = grads
    return step


def _own_grad(handle: Tensor) -> Tensor:
    """``handle`` with a hook that gives it a gradient of its own: where a
    row reads the piece on its own device, the gather's backward hands the
    piece a slice of the whole leaf's gradient, which autograd keeps as
    the piece's .grad -- the whole leaf's gradient on the row's device
    would live until the row's backward ends (the whole model's, 4x a
    card's share on a grid of 4). A copy of the slice frees it at once;
    the values are the same."""
    def own(h):
        g = h.grad
        if g is not None and \
                g.untyped_storage().nbytes() > g.numel() * g.element_size():
            h.grad = g.clone()
    handle.register_post_accumulate_grad_hook(own)
    return handle


def _replicate(sh: Sharding, trees: List[List[Tensor]]) -> None:
    """Copy each block's primary into its other holders, where they are
    other tensors (other cards; on logical devices of one card the
    holders share one tensor)."""
    owner = sh.owners(trees[0][0].dim())
    for pieces in trees:
        for i, o in enumerate(owner):
            if pieces[i] is not pieces[o]:
                pieces[i].copy_(pieces[o])


def _two_level_mean(xs: List[Tensor], inner: int, home) -> Tensor:
    """The mean over the innermost dp axis (runs of ``inner`` shards),
    then over the outer axes, each in f32 and cast back, on ``home``."""
    dtype = xs[0].dtype
    parts = [(sum(x.to(torch.float32).to(home) for x in xs[i:i + inner])
              / inner).to(dtype) for i in range(0, len(xs), inner)]
    if len(parts) == 1:
        return parts[0]
    return (sum(p.to(torch.float32) for p in parts) / len(parts)).to(dtype)


def make_ddp_train_step(cfg: ModelConfig, opt: OptConfig,
                        grid: Optional[DeviceGrid] = None,
                        compress: bool = True) -> Step:
    """ddp_step(state, batch) -> (state, metrics) over ``grid`` (its axes
    all dp axes; ``ddp_grid`` of the parameters' device by default);
    ``state`` from ``init_ddp_state`` on the same grid."""

    def step(state: State, batch: Dict[str, object]):
        g = ddp_grid(state["params"].device) if grid is None else grid
        dp = dp_axes(g)
        if dp != g.axis_names:
            raise ValueError(f"the DDP grid's axes {g.axis_names} must all "
                             f"be dp axes ('pod', 'data')")
        n, inner = g.size, g.axis_sizes[dp[-1]]
        if len(state["residual"]) != n:
            raise ValueError(f"the state holds {len(state['residual'])} "
                             f"shards' residuals, the grid {n} devices")
        replicas = {r["params"].device: r for r in ddp_replicas(state)}
        flat = g.flat
        if set(flat) != set(replicas):
            raise ValueError(f"the state's replicas are on "
                             f"{sorted(map(str, replicas))}, the grid's "
                             f"devices {sorted(set(map(str, flat)))}")
        home = flat[0]
        losses, shard_grads = [], []
        for piece, dev in zip(_split(batch, n), flat):
            params = replicas[dev]["params"]
            loss, grads = _grads(params, dict(params.named_parameters()),
                                 _on_device(piece, dev), cfg)
            losses.append(loss)
            shard_grads.append(grads)
        loss = _two_level_mean(losses, inner, home)
        names = list(shard_grads[0])
        residual = state["residual"]
        if compress:
            per_leaf = {}
            residual = [dict() for _ in range(n)]
            for k in names:
                payloads, errs = quantize_shards(
                    [sg[k] for sg in shard_grads],
                    [r[k] for r in state["residual"]])
                per_leaf[k] = payloads
                for d, e in zip(residual, errs):
                    d[k] = e
        else:
            mean = {k: _two_level_mean([sg[k] for sg in shard_grads],
                                       inner, home) for k in names}
        for dev, rep in replicas.items():
            named = dict(rep["params"].named_parameters())
            if compress:
                grads = {}
                for k in names:
                    x = shard_grads[0][k]
                    means = [mean_of_payloads(per_leaf[k][i:i + inner],
                                              x.shape, x.dtype, dev)
                             for i in range(0, n, inner)]
                    grads[k] = _two_level_mean(means, len(means), dev) \
                        if len(means) > 1 else means[0]
            else:
                grads = {k: m.to(dev) for k, m in mean.items()}
            rep["opt"], metrics = _update(named, grads, rep["opt"], opt)
            del grads
            if dev == home:
                out = metrics
        del shard_grads
        state["opt"] = replicas[home]["opt"]
        state["residual"] = residual
        return state, dict(out, loss=loss)

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
    it): parameters copied in place, the rest taken over; every other
    DDP replica set to the same values on its card."""
    with torch.no_grad():
        for n, p in state["params"].named_parameters():
            p.copy_(tree["params"][n])
    state["opt"] = tree["opt"]
    if "residual" in tree:
        # each shard's residual stays on its shard's device
        state["residual"] = [
            {n: t.to(old[n].device) for n, t in r.items()}
            for r, old in zip(tree["residual"], state["residual"])]
    if "replicas" in state:
        state["replicas"] = [{"params": state["params"],
                              "opt": state["opt"]}] + [
            _replica(state, r["params"].device)
            for r in state["replicas"][1:]]
    return state
