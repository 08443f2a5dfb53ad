"""Models held as shards on a device grid: the pieces, and the layer-shard
helpers that the sharded trainer (train/train_step.py) and sharded
serving (models/model.py: ``prefill``, ``decode_step`` and ``encode`` on
a ``ShardedLM``) share.

A ``ShardedLM`` holds each parameter as its pieces, one a grid device
(row-major), laid out by its ``Sharding`` (sharding/rules.py:
``param_shardings``); holders of one block on one device share one
tensor. ``models.model.init_params(..., shardings=)``,
``convert.lm_params_from_numpy(..., shardings=)`` and
``checkpoint.manager.CheckpointManager.restore(..., shardings=)`` make
one without the whole model on any card (``as_sharded`` takes the
restored {name: pieces} as it is).

A dp row computes with ``row_model`` on the row path: the top-level
leaves (``embed``, ``final_norm``, ``lm_head``, ``meta``, ``enc_norm``)
gathered whole onto the row's device, each layer a ``LayerShards`` whose
``gather()`` reads the layer whole onto that device as it runs, each
block from the row's own devices where they hold it (``RowPlan.order``).
With ``experts``, a MoE layer's expert group g is assembled instead on
the row's device of model index g from the pieces that lie on model
index g, over the dp axes only (``RowPlan.group_orders``), and handed to
models/moe.py as ``ep_groups``: no card holds a whole expert stack.

Serving and training over "model" (models/model.py's model path)
compute with ``ModelRow`` instead: the row's device of each model index
g (``RowPlan.group_devices``), ``local`` reading each leaf's block at
model index g on that device -- its own piece, with no copy, on a (1, N)
grid; gathered over the dp axes only elsewhere -- and ``whole_layer`` /
``whole`` reading a layer / a leaf whole onto every device of the row
(prefill, the train step) through ``gather_copies``: under grad, where a
piece is read by several model indices, one copy an index, whose
backward adds the copies' gradients into each piece in f32 in
model-index order and rounds once (autograd would add them in the order
the cards' backward threads finish, so two runs could differ). The
collectives between the row's devices
(``all_gather``, ``all_reduce``, ``reduce_scatter``) are copies and sums
in model-index order, so every device of a row gets the same numbers, on
logical devices and on cards; ``seq_gather`` gathers a context-parallel
step's K and V with a backward of its own: each chunk's gradient is the
sum of every device's share of it, added in f32 in model-index order on
the chunk's device and rounded once.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

#: a MoE layer's expert stacks (E, ...), laid out with the experts over
#: "model" (sharding/rules.py)
EXPERT_LEAVES = ("moe.w_gate", "moe.w_up", "moe.w_down")


def shard_leaf(sh, t: Tensor) -> List[Tensor]:
    """``sh.shard(t)``, one tensor shared by the holders of a block on one
    device."""
    t = t.detach()
    pieces, seen = sh.shard(t), {}
    return [seen.setdefault((b, p.device), p)
            for b, p in zip(sh.blocks(t.dim()), pieces)]


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """One dp row of a grid: its context (every dp axis of size 1, the
    row's devices), its device (the row's first), the order its reads
    prefer (flat grid indices, its own devices first) and, for each model
    index g, the row's device there and the order that reads the blocks
    on model index g first (the row's own device, then the other rows')."""
    ctx: object
    device: torch.device
    order: Tuple[int, ...]
    group_devices: Tuple[torch.device, ...]
    group_orders: Tuple[Tuple[int, ...], ...]


def row_plans(ctx) -> List[RowPlan]:
    """The dp rows of ``ctx``'s grid (models/moe.py: ``ShardingCtx.rows``),
    row-major over the dp axes."""
    grid = ctx.grid
    idx = list(grid.indices())
    row = [ctx.row_of(i) for i in idx]
    tp = (grid.axis_names.index(ctx.tp_axis)
          if ctx.tp_axis in grid.axis_names else None)
    group = [0 if tp is None else i[tp] for i in idx]
    n_g = 1 if tp is None else grid.shape[tp]
    everyone = range(len(idx))
    plans = []
    for r, rctx in enumerate(ctx.rows()):
        own = [k for k in everyone if row[k] == r]
        order = own + [k for k in everyone if row[k] != r]
        g_devs, g_orders = [], []
        for g in range(n_g):
            mine = [k for k in own if group[k] == g]
            there = [k for k in everyone if group[k] == g and row[k] != r]
            g_devs.append(grid.flat[mine[0]])
            g_orders.append(tuple(mine + there + [k for k in order
                                                  if group[k] != g]))
        plans.append(RowPlan(rctx, rctx.grid.flat[0], tuple(order),
                             tuple(g_devs), tuple(g_orders)))
    return plans


class ShardedLeaves:
    """A layer's parameters held as shards: ``gather()`` reads them whole
    onto the computing device."""

    def gather(self):
        raise NotImplementedError


class LayerShards(ShardedLeaves):
    """One layer's parameters held as shards ({path: (Sharding, pieces)});
    ``gather()`` reads each leaf whole onto the row's device
    (models/model.py calls it as the layer runs, and again in the
    recomputed backward), or, with ``experts``, a MoE layer's expert
    stacks as their groups (``ep_groups``, models/moe.py)."""

    def __init__(self, leaves: Dict[str, Tuple[object, List[Tensor]]],
                 plan: RowPlan, experts: bool = False):
        self.leaves, self.plan, self.experts = leaves, plan, experts

    @property
    def key(self):
        """Rows whose layers gather to the same devices (logical devices
        of one card) may share one gathered copy."""
        return self.plan.device, self.plan.group_devices

    def _grouped(self) -> bool:
        """Whether the expert stacks split into the row's model groups."""
        if not self.experts or EXPERT_LEAVES[0] not in self.leaves:
            return False
        n_g = len(self.plan.group_devices)
        return all(self.leaves[p][0].counts(self.leaves[p][1][0].dim())[0]
                   == n_g for p in EXPERT_LEAVES)

    def _expert_groups(self):
        """{(g, device): (router, w_gate, w_up, w_down)}: the router whole
        (``gather_copies``) and expert group g on the row's device of
        model index g."""
        plan = self.plan
        routers = gather_copies(*self.leaves["moe.router"],
                                plan.group_devices, plan.group_orders)
        out = {}
        for g, (dev, order) in enumerate(zip(plan.group_devices,
                                             plan.group_orders)):
            out[(g, dev)] = (routers[g],) + tuple(
                self.leaves[p][0].gather(self.leaves[p][1], dev, order,
                                         lead=(g,))
                for p in EXPERT_LEAVES)
        return out

    def gather(self, device=None, order=None, groups=None):
        """The layer whole on ``device`` (the row's, read in ``order``, by
        default), the expert stacks as their groups where grouped
        (``groups``: already assembled ones to share)."""
        if groups is None and self._grouped():
            groups = self._expert_groups()
        device = self.plan.device if device is None else device
        order = self.plan.order if order is None else order
        return self.assemble({path: sh.gather(pieces, device, order)
                              for path, (sh, pieces) in
                              self.dense(groups).items()}, groups)

    def dense(self, groups) -> Dict[str, Tuple[object, List[Tensor]]]:
        """The leaves read whole: all but the expert stacks and router
        where ``groups`` holds them."""
        skip = (EXPERT_LEAVES + ("moe.router",)) if groups else ()
        return {p: v for p, v in self.leaves.items() if p not in skip}

    @staticmethod
    def assemble(flat: Dict[str, Tensor], groups):
        """The layer's namespace from its whole leaves, the expert groups
        attached (``moe.ep_groups``)."""
        out = namespace(flat)
        if groups:
            if not hasattr(out, "moe"):
                out.moe = types.SimpleNamespace()
            out.moe.ep_groups = groups
        return out


def on_devices(devices: Sequence[torch.device], fn) -> list:
    """[fn(g) for each model index g], fn run once a distinct device and
    its result shared by the indices on that device: for values every
    device of a row holds alike (a replicated norm, a reduced sum)."""
    memo: Dict[torch.device, object] = {}
    out = []
    for g, dev in enumerate(devices):
        if dev not in memo:
            memo[dev] = fn(g)
        out.append(memo[dev])
    return out


def reduce_to(parts: Sequence[Tensor], device) -> Tensor:
    """The sum of ``parts`` on ``device``, added in their order."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def all_reduce(parts: Sequence[Tensor], devices) -> List[Tensor]:
    """Each device's sum of every device's part, in model-index order (the
    reference's psum over "model"): the same numbers on every device,
    each pulling the parts itself (one hop between cards; a sum on one
    card copied out to the others took longer on 4 H100s)."""
    return on_devices(devices, lambda g: reduce_to(parts, devices[g]))


def all_gather(parts: Sequence[Tensor], devices, dim: int) -> List[Tensor]:
    """Each device's concatenation of every device's part along ``dim``,
    in model-index order, each pulling the parts itself."""
    return on_devices(devices, lambda g: torch.cat(
        [p.to(devices[g]) for p in parts], dim))


def reduce_scatter(parts: Sequence[Tensor], devices,
                   bounds: Sequence[Tuple[int, int]], dim: int
                   ) -> List[Tensor]:
    """Device g's run [s_g, e_g) (``bounds``) along ``dim`` of the sum of
    every device's part, added in model-index order on device g."""
    return [reduce_to([p.narrow(dim, s, e - s) for p in parts], dev)
            for dev, (s, e) in zip(devices, bounds)]


class _SeqGather(torch.autograd.Function):
    """``seq_gather``: forward(devices, *parts) -> one concatenation a
    model index -- one a distinct device where no part takes a gradient
    (``all_gather``), else one a model index, also where devices repeat,
    so each index's gradient arrives apart; backward: part i's gradient is
    the sum over the indices g of g's gradient at part i's positions, in
    f32 in model-index order on part i's device, rounded once to its
    dtype (four bf16 partials added in bf16 would round three more times
    than the whole sequence's single f32 accumulation)."""

    @staticmethod
    def forward(ctx, devices, *parts):
        if not any(ctx.needs_input_grad[1:]):
            return tuple(all_gather(parts, devices, 1))
        ctx.devices = devices
        ctx.sizes = [p.shape[1] for p in parts]
        ctx.dtype = parts[0].dtype
        return tuple(torch.cat([p.to(d) for p in parts], 1) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        out, s = [], 0
        for dev, n in zip(ctx.devices, ctx.sizes):
            acc = None
            for g in grads:
                if g is not None:
                    part = g.narrow(1, s, n).to(dev, torch.float32)
                    acc = part if acc is None else acc + part
            out.append(None if acc is None else acc.to(ctx.dtype))
            s += n
        return (None, *out)


def seq_gather(parts: Sequence[Tensor], devices) -> List[Tensor]:
    """Each device's concatenation of the row's parts (B, S_g, ...)
    along the sequence, in model-index order, with the gradient
    ``_SeqGather`` gives it."""
    return list(_SeqGather.apply(tuple(devices), *parts))


class _Fork(torch.autograd.Function):
    """``fork``: forward(index, *tensors) -> tensors[index[i]] again for
    each i, as a new tensor on its storage; backward: each tensor's
    gradient, the sum of its aliases' in argument order, once every alias
    has its own (the engine runs a node when all its uses have
    delivered)."""

    @staticmethod
    def forward(ctx, index, *tensors):
        ctx.set_materialize_grads(False)
        ctx.index = index
        return tuple(tensors[j].view_as(tensors[j]) for j in index)

    @staticmethod
    def backward(ctx, *grads):
        out: List[Optional[Tensor]] = [None] * (max(ctx.index) + 1)
        for j, g in zip(ctx.index, grads):
            if g is not None:
                out[j] = g if out[j] is None else out[j] + g
        return (None, *out)


def fork(*tensors: Tensor) -> Tuple[Tensor, ...]:
    """``tensors`` as their uses should read them under grad: one alias
    an argument (a tensor passed twice gives two uses two aliases), the
    graph behind them differentiated only once every alias's gradient has
    come, each tensor's the sum of its aliases' in argument order -- one
    contribution. Where some uses wait on other cards (a gather's
    backward) and others do not, the contributions would otherwise reach a
    tensor in the order the cards' threads deliver them, and f32 sums of
    three or more would differ between runs."""
    if not torch.is_grad_enabled() or not any(t.requires_grad
                                              for t in tensors):
        return tensors
    ids: Dict[int, int] = {}
    distinct = []
    for t in tensors:
        if id(t) not in ids:
            ids[id(t)] = len(distinct)
            distinct.append(t)
    return _Fork.apply(tuple(ids[id(t)] for t in tensors), *distinct)


class _Copies(torch.autograd.Function):
    """``gather_copies`` where a piece takes a gradient: forward(plan,
    *pieces) -> the leaf gathered onto the device of each model index, one
    copy an index (also where devices repeat, so each index's gradient
    arrives apart); backward: each piece's gradient is the sum over the
    indices g of g's gradient at the positions its copy read from the
    piece, added in f32 in model-index order on the piece's device and
    rounded once to its dtype. Autograd would add the copies' gradients
    into the piece in the order the cards' backward threads deliver them,
    in the piece's dtype, so two runs could differ."""

    @staticmethod
    def forward(ctx, plan, *pieces):
        sh, devices, orders, kw, index, reads = plan
        full = [pieces[j] for j in index]
        outs = [sh.gather(full, dev, order, **kw)
                for dev, order in zip(devices, orders)]
        ctx.reads = reads
        ctx.dests = [(p.device, p.dtype) for p in pieces]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        acc: List[Optional[Tensor]] = [None] * len(ctx.dests)
        for grad, reads in zip(grads, ctx.reads):
            if grad is None:
                continue
            for j, sl in reads:
                part = grad[sl].to(ctx.dests[j][0], torch.float32)
                acc[j] = part if acc[j] is None else acc[j] + part
        return (None, *(None if a is None else a.to(dtype)
                        for a, (_, dtype) in zip(acc, ctx.dests)))


def gather_copies(sh, pieces: Sequence[Tensor], devices, orders,
                  **kw) -> List[Tensor]:
    """``sh.gather(pieces, devices[g], orders[g], **kw)`` for each model
    index g: one copy a distinct device (``on_devices``), or, where a
    piece takes a gradient and is read by two or more indices, one copy
    an index through ``_Copies``, whose backward sums the copies'
    gradients in model-index order."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in pieces):
        ids: Dict[int, int] = {}
        distinct = []
        for p in pieces:
            if id(p) not in ids:
                ids[id(p)] = len(distinct)
                distinct.append(p)
        index = [ids[id(p)] for p in pieces]
        shape = tuple(n * c for n, c in zip(pieces[0].shape,
                                             sh.counts(pieces[0].dim())))
        # each index's reads: (the distinct piece, the slices it fills)
        reads = [[(index[i], sl) for i, sl in
                  sh.reads(shape, len(pieces), order, **kw)]
                 for order in orders]
        readers = [{g for g, r in enumerate(reads) for j, _ in r if j == k}
                   for k in range(len(distinct))]
        if any(len(r) > 1 for r in readers):
            return list(_Copies.apply((sh, tuple(devices), tuple(orders), kw,
                                       index, reads), *distinct))
    return on_devices(devices, lambda g: sh.gather(pieces, devices[g],
                                                   orders[g], **kw))


def gathered_rows(layers: Sequence[object]) -> List[object]:
    """One layer of each dp row, gathered (where held as shards) before
    any row runs it: every card's copies of the layer are queued before
    any card computes it, so the cards run the layer at once (a copy runs
    on its source card's stream, after that card's queued work); rows on
    one device share one copy. A whole row's layer passes as it is."""
    shared, out = {}, []
    for lp in layers:
        if isinstance(lp, LayerShards):
            if lp.key not in shared:
                shared[lp.key] = lp.gather()
            lp = shared[lp.key]
        out.append(lp)
    return out


def namespace(flat: Dict[str, Tensor]):
    """{"attn.wq": t, ...} -> a namespace tree (lp.attn.wq)."""
    root: Dict[str, object] = {}
    for path, t in flat.items():
        node = root
        *dirs, leaf = path.split(".")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = t

    def build(node):
        return types.SimpleNamespace(**{
            k: build(v) if isinstance(v, dict) else v
            for k, v in node.items()})
    return build(root)


def layer_stacks(pieces: Dict[str, List[Tensor]], shardings
                 ) -> Dict[str, Dict[int, Dict[str, tuple]]]:
    """{"layers" / "enc_layers": {i: {path in the layer: (Sharding,
    pieces)}}} of a model's layer leaves."""
    stacks: Dict[str, Dict[int, Dict[str, tuple]]] = {
        "layers": {}, "enc_layers": {}}
    for n, ps in pieces.items():
        parts = n.split(".")
        if parts[0] in stacks:
            stacks[parts[0]].setdefault(int(parts[1]), {})[
                ".".join(parts[2:])] = (shardings[n], ps)
    return stacks


def row_model(cfg, pieces: Dict[str, List[Tensor]], shardings,
              plan: RowPlan, experts: bool = False,
              memo: Optional[Dict] = None):
    """The model as one dp row computes it: the top-level leaves gathered
    onto the row's device now, each layer a ``LayerShards``. ``memo``
    ({(name, device): tensor}): top-level leaves already gathered onto a
    device by another row of the call (rows on logical devices of one
    card share one copy; every holder of a block holds its same
    values)."""
    memo = {} if memo is None else memo
    top, stacks = {}, layer_stacks(pieces, shardings)
    for n, ps in pieces.items():
        if n.split(".")[0] not in stacks:
            key = (n, plan.device)
            if key not in memo:
                memo[key] = shardings[n].gather(ps, plan.device, plan.order)
            top[n] = memo[key]
    model = namespace(top)
    model.cfg, model.device = cfg, torch.device(plan.device)
    for k, layers in stacks.items():
        if layers:
            setattr(model, k, [LayerShards(layers[i], plan, experts)
                               for i in range(len(layers))])
    return model


class ModelRow:
    """One dp row of a grid whose "model" axis is larger than 1, as serving
    over "model" computes it: ``devices[g]``, the row's device of model
    index g, and ``flat[g]``, its flat grid index. ``local(name)`` reads
    each device's block of a parameter -- split over "model" along
    ``model_dim(name)``, whole along every other dimension -- from the
    pieces at its model index: on a (1, N) grid its own piece, with no
    copy. ``whole_layer(i)`` reads layer i whole onto every device of the
    row (``gather_copies``: one copy a distinct device, or under grad one
    a model index), the MoE's expert stacks as their
    groups (group g on device g, ``moe.ep_groups``); ``whole_layer(i,
    "enc_layers")`` the encoder's layer i."""

    def __init__(self, model: "ShardedLM", plan: RowPlan):
        self.model, self.plan = model, plan
        self.devices = plan.group_devices
        self.flat = tuple(order[0] for order in plan.group_orders)
        self._stacks = layer_stacks(model.pieces, model.shardings)
        self._own: Dict[str, list] = {}

    @property
    def tp(self) -> int:
        return len(self.devices)

    def model_dim(self, name: str) -> Optional[int]:
        return self.model.shardings[name].model_dim(
            self.model.pieces[name][0].dim())

    def local(self, name: str) -> List[Tensor]:
        """Each device's block of ``name``; kept for the next call where
        every block is a piece itself (a (1, N) grid), never where it was
        gathered (the dp axes' copies are dropped after use)."""
        if name in self._own:
            return self._own[name]
        sh, pieces = self.model.shardings[name], self.model.pieces[name]
        d = self.model_dim(name)
        out = [sh.gather(pieces, dev, order, at=None if d is None
                         else {d: g})
               for g, (dev, order) in enumerate(zip(
                   self.devices, self.plan.group_orders))]
        if all(any(t is p for p in pieces) for t in out):
            self._own[name] = out
        return out

    def local_tree(self, prefix: str) -> List[object]:
        """Each device's blocks of the parameters under ``prefix``
        ("layers.3.ln1") as a namespace (``.scale``, ``.bias``); kept
        where every block is kept (``local``)."""
        if prefix in self._own:
            return self._own[prefix]
        names = [n for n in self.model.pieces if n.startswith(prefix + ".")]
        blocks = {n: self.local(n) for n in names}
        out = [namespace({n[len(prefix) + 1:]: b[g]
                          for n, b in blocks.items()})
               for g in range(self.tp)]
        if all(n in self._own for n in names):
            self._own[prefix] = out
        return out

    def _copies(self, sh, pieces) -> List[Tensor]:
        return gather_copies(sh, pieces, self.devices,
                             self.plan.group_orders)

    def whole(self, name: str) -> List[Tensor]:
        """``name`` whole on every device of the row, each reading its own
        model index's blocks first (``gather_copies``)."""
        return self._copies(self.model.shardings[name],
                            self.model.pieces[name])

    def whole_layer(self, i: int, stack: str = "layers") -> List[object]:
        lsh = LayerShards(self._stacks[stack][i], self.plan, experts=True)
        groups = lsh._expert_groups() if lsh._grouped() else None
        copies = {path: self._copies(sh, pieces)
                  for path, (sh, pieces) in lsh.dense(groups).items()}
        return [lsh.assemble({path: c[g] for path, c in copies.items()},
                             groups) for g in range(self.tp)]


class ShardedLM:
    """An LM's parameters held as shards: ``pieces[name]``, one tensor a
    grid device (row-major), laid out by ``shardings[name]`` (every
    sharding on one grid). Checked against the config's parameters
    (``models.model.param_shapes``): the names, each piece's block shape
    and dtype, and each piece on its grid device; ValueError otherwise."""

    def __init__(self, cfg, shardings: Dict[str, object],
                 pieces: Dict[str, Sequence[Tensor]]):
        from ..core.detector import _same_device
        from .model import param_shapes
        shapes = param_shapes(cfg)
        for what, names in (("pieces", pieces), ("shardings", shardings)):
            if set(names) != set(shapes):
                raise ValueError(
                    f"{cfg.name}: the {what}' names differ from the model's "
                    f"parameters at {sorted(set(names) ^ set(shapes))}")
        grids = {sh.grid for sh in shardings.values()}
        if len(grids) != 1:
            raise ValueError("the parameters' shardings lie on different "
                             "grids")
        (grid,) = grids
        devices = grid.flat
        for n, meta in shapes.items():
            ps, want = pieces[n], shardings[n].block_shape(tuple(meta.shape))
            if len(ps) != grid.size:
                raise ValueError(f"{n}: {len(ps)} pieces on a grid of "
                                 f"{grid.size} devices")
            for p, d in zip(ps, devices):
                if not _same_device(p.device, d):
                    raise ValueError(f"{n}: a piece on {p.device} where the "
                                     f"grid's device is {d}")
                if tuple(p.shape) != want or p.dtype != meta.dtype:
                    raise ValueError(
                        f"{n}: a piece of {tuple(p.shape)} {p.dtype}, the "
                        f"sharding's block is {want} {meta.dtype}")
        self.cfg, self.grid = cfg, grid
        self.shardings = dict(shardings)
        self.pieces = {n: list(pieces[n]) for n in shapes}
        #: each context's ModelRows (models/model.py's model path)
        self.model_rows: Dict[object, List[ModelRow]] = {}

    @property
    def device(self) -> torch.device:
        """The grid's first device: where logits and tokens return."""
        return self.grid.flat[0]


def as_sharded(params, cfg, ctx=None) -> Optional[ShardedLM]:
    """``params`` as a ``ShardedLM``, or None where it is held whole (a
    ``CausalLM``). A {name: pieces} dict (``CheckpointManager.restore``
    with ``param_shardings(ctx.grid, ...)``) takes that layout; a
    ``ShardedLM`` must lie on ``ctx``'s grid where ``ctx`` is given."""
    if isinstance(params, dict):
        if ctx is None:
            raise ValueError("parameters held as {name: pieces} need ctx "
                             "(their grid)")
        from ..sharding.rules import param_shardings
        from .model import param_shapes
        return ShardedLM(cfg, param_shardings(ctx.grid, param_shapes(cfg),
                                              cfg), params)
    if isinstance(params, ShardedLM):
        if ctx is not None and ctx.grid != params.grid:
            raise ValueError(f"the model's pieces lie on a grid of "
                             f"{params.grid.shape} {params.grid.axis_names}, "
                             f"ctx's grid is {ctx.grid.shape} "
                             f"{ctx.grid.axis_names}")
        return params
    return None
