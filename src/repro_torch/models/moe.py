"""Mixture-of-Experts FFN with expert parallelism (port of
repro/models/moe.py).

Top-k routing into per-expert capacity buffers with token dropping (the
GShard/Switch discipline), a SwiGLU per expert as batched matmuls over
every expert's buffer, and the weighted combine back to token order;
llama4's always-on shared expert is added on top. Three paths, one
routing, chosen by ``moe_ffn`` under the reference's conditions:

  * local -- no ``ctx``: capacity buffers over the whole batch on one
    device.
  * EP all-to-all (``_moe_ep_a2a``) -- tokens split over (dp x ep): B
    over the dp axes (row-major), S over "model"; each shard routes its
    own T_l tokens at its own ``_capacity(T_l)`` (per-shard capacity is
    what changes which tokens drop), sends expert group g's (E_l, C, D)
    rows to model index g, where they stand source shard by source shard
    (the reference's untiled all_to_all plus swapaxes); each EP shard
    runs its E_l experts on its (E_l, ep * C, D) rows on its device; the
    rows go back and each shard combines in slot order. Taken when B
    divides over dp, S over ep and the sequence is sharded (prefill,
    training).
  * EP replicated (``_moe_ep_replicated``) -- decode: each dp row's tokens
    go to every EP shard, which routes them all, runs only its local
    experts and combines; the shards' outputs are summed in shard order
    (the reference's psum).

The collectives are explicit copies between the grid's devices
(``ShardingCtx.grid``; one card repeated under REPRO_TEST_DEVICES, where
a copy is a no-op view) and sums in a fixed order, so a run is
deterministic and the same on logical devices and on cards. The EP
paths read the router and expert group g's weights on the devices of
model index g (``_expert_groups``): laid out there from the layer's (E,
D, F) leaves the first time a grid runs them and kept on the layer for
the next call while those leaves are unchanged (a served model's
experts live on their cards); a trainer's forward, where autograd
records the copies, lays them out anew each call. A model held as
shards brings each group assembled from the pieces on its model index
(models/sharded.py), and no device holds a whole expert stack.

Order and determinism, where the card would otherwise differ from the
CPU and the reference:
  * top-k is a stable descending sort: ties keep the lower expert first,
    as ``lax.top_k`` does (``torch.topk`` does not promise it);
  * the dispatch adds each kept token into its (expert, slot) once and
    the dropped ones' zeros into slot C - 1, as the reference's
    ``buf.at[e, slot].add`` does; adding zeros is exact in any order;
  * the combine adds each token's k contributions in slot order 0 .. k-1,
    each add rounded in the model's dtype, as the reference's
    sequential scatter-add over ``tok_ids = repeat(arange(T), k)`` does,
    instead of an atomic ``index_add_`` whose order varies.

``_capacity`` depends on the token count of the call: a prefill of T
tokens and a decode step of B tokens have different capacities, and an
overflowing expert drops the latest tokens first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .configs import ModelConfig
from .layers import swiglu

Tensor = torch.Tensor

#: moe_ffn calls by path since the last reset_paths(), as chip_smoke.py
#: and the tests read which path a run took
path_counts: Dict[str, int] = {"local": 0, "a2a": 0, "replicated": 0}


def reset_paths() -> None:
    for k in path_counts:
        path_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """How the model is laid out on a device grid (sharding/rules.py:
    ``make_ctx``). The reference's activation constraints (``act3``,
    ``act_q``, ``act_kv_gathered``, ``act_scores``, ``act_logits``) have no
    counterpart: the port computes each shard explicitly, so no layout is
    left for a compiler to choose. ``bf16_scores``, ``banded`` and
    ``flash_vjp`` select attention's masked paths
    (models/attention.py)."""
    grid: object                     # launch/mesh.py:DeviceGrid
    dp_axes: Tuple[str, ...]         # batch axes, e.g. ('pod', 'data')
    tp_axis: str = "model"           # tensor/expert-parallel axis
    seq_sharded: bool = True         # shard sequence over tp_axis too
    bf16_scores: bool = False        # half-width score tensors
    banded: bool = False             # banded sliding-window attention
    flash_vjp: bool = False          # sdpa_flash's forward
    kv_shard_dim: str = "length"     # the decode cache over tp_axis:
                                     # "length" or "heads" (its profile's)

    @property
    def ep_size(self) -> int:
        return self.grid.axis_sizes[self.tp_axis]

    @property
    def seq_axis(self):
        return self.tp_axis if self.seq_sharded else None

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.grid.axis_sizes[a]
        return n

    def row_of(self, index) -> int:
        """The dp row of a grid index: row-major over the dp axes."""
        coord = dict(zip(self.grid.axis_names, index))
        r = 0
        for a in self.dp_axes:
            r = r * self.grid.axis_sizes[a] + coord[a]
        return r

    def shard_devices(self) -> List[List[torch.device]]:
        """devices[r][g]: the device of dp row r (row-major over the dp
        axes) and model index g. Raises ValueError on a grid with other
        axes."""
        other = set(self.grid.axis_names) - set(self.dp_axes) \
            - {self.tp_axis}
        if other:
            raise ValueError(f"an EP grid has only dp axes and "
                             f"{self.tp_axis!r}; this one has {sorted(other)}")
        out = [[None] * self.ep_size for _ in range(self.dp_size)]
        tp = self.grid.axis_names.index(self.tp_axis)
        for index in self.grid.indices():
            out[self.row_of(index)][index[tp]] = self.grid.device(index)
        return out

    def rows(self) -> List["ShardingCtx"]:
        """One context a dp row: the grid's devices of that row, every dp
        axis of size 1 (the row's shards of the EP paths)."""
        from ..launch.mesh import grid_of
        shape = tuple(1 if a in self.dp_axes else n
                      for a, n in zip(self.grid.axis_names, self.grid.shape))
        rows: List[list] = [[] for _ in range(self.dp_size)]
        for index in self.grid.indices():
            rows[self.row_of(index)].append(self.grid.device(index))
        return [dataclasses.replace(self, grid=grid_of(
            devs, shape, self.grid.axis_names)) for devs in rows]


def _expert_groups(p, ctx: ShardingCtx
                   ) -> Dict[Tuple[int, torch.device], Tuple[Tensor, ...]]:
    """{(g, device): (router, w_gate, w_up, w_down)}: the router and
    expert group g's weights on each device of model index g (replicated
    over the dp rows); views on logical devices of one card. Kept on
    ``p`` (``p.ep_layout``) while the grid and the leaves (their storage
    and in-place version) stay the same, unless autograd records the
    copies, whose graph belongs to one call. A layer served from shards
    brings its groups already assembled on their devices
    (``p.ep_groups``, models/sharded.py), without the whole stacks."""
    if getattr(p, "ep_groups", None) is not None:
        return p.ep_groups
    ws = (p.router, p.w_gate, p.w_up, p.w_down)
    devs = ctx.shard_devices()
    key = (tuple(map(tuple, devs)),
           tuple((w.data_ptr(), -1 if w.is_inference() else w._version)
                 for w in ws))
    recorded = torch.is_grad_enabled() and any(w.requires_grad for w in ws)
    kept = getattr(p, "ep_layout", None)
    if not recorded and kept is not None and kept[0] == key:
        return kept[1]
    E_l = p.w_gate.shape[0] // ctx.ep_size
    out = {(g, d): (p.router.to(d),) + tuple(
               w[g * E_l:(g + 1) * E_l].to(d) for w in ws[1:])
           for row in devs for g, d in enumerate(row)}
    if not recorded:
        p.ep_layout = (key, out)
    return out


def _top_k(gates: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest gates of each row and their expert ids, largest
    first, the lower id first among equal gates (``lax.top_k``'s order)."""
    w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return w[:, :k], idx[:, :k]


def _route(x_flat: Tensor, gates: Tensor, cfg: ModelConfig,
           capacity: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Top-k routing into per-expert capacity buffers.

    x_flat: (T, D), gates: (T, E) f32 probabilities. Returns (buf (E, C,
    D), tok_ids (T*k,), slot (T*k,), weight (T*k,) in x's dtype); slot
    == C means dropped. A token's rank in its expert counts the earlier
    (token, choice) pairs routed there, token-major."""
    T, D = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    w, e_idx = _top_k(gates, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalize
    e_flat = e_idx.reshape(-1)
    w_flat = w.reshape(-1).to(x_flat.dtype)
    tok_ids = torch.arange(T, device=x_flat.device).repeat_interleave(k)
    onehot = F.one_hot(e_flat, E)
    ranks = torch.cumsum(onehot, dim=0) - onehot           # place in expert
    slot = ranks.gather(1, e_flat[:, None])[:, 0]
    keep = slot < capacity
    slot_c = torch.where(keep, slot, capacity - 1)
    contrib = torch.where(keep[:, None], x_flat[tok_ids],
                          x_flat.new_zeros(()))
    buf = x_flat.new_zeros((E, capacity, D))
    buf.index_put_((e_flat, slot_c), contrib, accumulate=True)
    slot_out = torch.where(keep, slot, capacity)           # C == dropped
    return buf, tok_ids, slot_out, w_flat


def _expert_ffn(buf: Tensor, wg: Tensor, wu: Tensor, wd: Tensor) -> Tensor:
    """(E, C, D) through each expert's SwiGLU -> (E, C, D)."""
    g = F.silu(torch.bmm(buf, wg))
    u = torch.bmm(buf, wu)
    return torch.bmm(g * u, wd)


def _combine(out_buf: Tensor, e_flat_slots: Tuple[Tensor, Tensor],
             w_flat: Tensor, T: int) -> Tensor:
    """Gather expert outputs back to token order and add each token's k
    weighted contributions, slot 0 first; the (expert, slot) pairs and
    weights come token-major, k a token, as ``_route`` emits them (its
    ``tok_ids`` are ``repeat(arange(T), k)``). A dropped slot contributes
    zeros."""
    e_flat, slot = e_flat_slots
    E, C, D = out_buf.shape
    padded = torch.cat([out_buf, out_buf.new_zeros((E, 1, D))], dim=1)
    vals = (padded[e_flat, slot] * w_flat[:, None]).view(T, -1, D)
    y = out_buf.new_zeros((T, D))
    for j in range(vals.shape[1]):
        y = y + vals[:, j]
    return y


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, int(c))


def _moe_local(x: Tensor, p, cfg: ModelConfig) -> Tensor:
    B, S, D = x.shape
    buf, slots, w_flat = _shard_route(x.reshape(B * S, D), p.router, cfg)
    out_buf = _expert_ffn(buf, p.w_gate, p.w_up, p.w_down)
    return _combine(out_buf, slots, w_flat, B * S).reshape(B, S, D)


def _shard_route(xl: Tensor, router: Tensor, cfg: ModelConfig):
    """Route one shard's (T_l, D) tokens (the whole batch on the local
    path) at its own capacity -> (buf, (e_flat, slot), w_flat)."""
    gates = torch.softmax(torch.matmul(xl, router).to(torch.float32), -1)
    buf, _, slot, w_flat = _route(xl, gates, cfg, _capacity(len(xl), cfg))
    return buf, (_top_k(gates, cfg.top_k)[1].reshape(-1), slot), w_flat


def ep_a2a_row(xs: List[Tensor], groups: List[Tuple[Tensor, ...]], devices,
               cfg: ModelConfig) -> List[Tensor]:
    """One dp row of the all-to-all path: ``xs[s]``, model index s's own
    (Bl, Sl, D) tokens on ``devices[s]``, each routed there at its own
    capacity; expert group g's rows sent to ``devices[g]``, run through
    ``groups[g]`` (router, w_gate, w_up, w_down) and sent back -> each
    index's (Bl, Sl, D) on its device."""
    ep = len(devices)
    E_l = cfg.n_experts // ep
    Bl, Sl, D = xs[0].shape
    routed = [_shard_route(x.reshape(Bl * Sl, D), groups[s][0], cfg)
              for s, x in enumerate(xs)]
    C = routed[0][0].shape[1]
    back = []
    for g, dev in enumerate(devices):
        # (ep_src, E_l, C, D) -> (E_l, ep_src * C, D)
        work = torch.stack([buf[g * E_l:(g + 1) * E_l].to(dev)
                            for buf, _, _ in routed], 1)
        out = _expert_ffn(work.reshape(E_l, ep * C, D), *groups[g][1:])
        back.append(out.view(E_l, ep, C, D))
    ys = []
    for s, dev in enumerate(devices):
        out_buf = torch.cat([b[:, s].to(dev) for b in back], 0)
        _, slots, w_flat = routed[s]
        ys.append(_combine(out_buf, slots, w_flat, Bl * Sl).view(Bl, Sl, D))
    return ys


def ep_replicated_row(xs: List[Tensor], groups: List[Tuple[Tensor, ...]],
                      devices, cfg: ModelConfig) -> List[Tensor]:
    """One dp row of the replicated path: ``xs[g]``, the row's (Bl, S, D)
    tokens on ``devices[g]`` (the same on each), routed there and run
    through expert group g alone -> each index's share (Bl, S, D) on its
    device, for the caller to sum in index order."""
    E_l = cfg.n_experts // len(devices)
    parts = []
    for g, x in enumerate(xs):
        router, *ws = groups[g]
        Bl, S, D = x.shape
        buf, slots, w_flat = _shard_route(x.reshape(Bl * S, D), router, cfg)
        out_buf = torch.zeros_like(buf)
        out_buf[g * E_l:(g + 1) * E_l] = _expert_ffn(
            buf[g * E_l:(g + 1) * E_l], *ws)
        parts.append(_combine(out_buf, slots, w_flat, Bl * S).view(Bl, S, D))
    return parts


def _moe_ep_a2a(x: Tensor, p, cfg: ModelConfig, ctx: ShardingCtx) -> Tensor:
    """Tokens split over (dp x ep), dispatched to and from the expert
    groups by copies (the reference's two all_to_alls)."""
    ep, dp = ctx.ep_size, ctx.dp_size
    B, S, D = x.shape
    Bl, Sl = B // dp, S // ep
    groups = _expert_groups(p, ctx)
    rows = []
    for r, row in enumerate(ctx.shard_devices()):
        xs = [x[r * Bl:(r + 1) * Bl, s * Sl:(s + 1) * Sl].to(dev)
              for s, dev in enumerate(row)]
        ys = ep_a2a_row(xs, [groups[(g, dev)] for g, dev in enumerate(row)],
                        row, cfg)
        rows.append(torch.cat([y.to(x.device) for y in ys], 1))
    return torch.cat(rows, 0)


def _moe_ep_replicated(x: Tensor, p, cfg: ModelConfig,
                       ctx: ShardingCtx) -> Tensor:
    """Decode: each dp row's tokens on every EP shard, which computes only
    its local experts; the shards' outputs summed in shard order."""
    dp = ctx.dp_size
    Bl = x.shape[0] // dp
    groups = _expert_groups(p, ctx)
    rows = []
    for r, row in enumerate(ctx.shard_devices()):
        xs = [x[r * Bl:(r + 1) * Bl].to(dev) for dev in row]
        parts = ep_replicated_row(
            xs, [groups[(g, dev)] for g, dev in enumerate(row)], row, cfg)
        y = parts[0].to(row[0])
        for part in parts[1:]:
            y = y + part.to(row[0])
        rows.append(y.to(x.device))
    return torch.cat(rows, 0)


def moe_path(B: int, S: int, cfg: ModelConfig,
             ctx: Optional[ShardingCtx]) -> str:
    """The path ``moe_ffn`` takes for a (B, S) batch: "local", "a2a" or
    "replicated", under the reference's conditions."""
    if ctx is None:
        return "local"
    ep = ctx.ep_size
    if cfg.n_experts % ep or B % ctx.dp_size:
        return "local"
    return "a2a" if ctx.seq_sharded and S % ep == 0 else "replicated"


def moe_ffn(x: Tensor, p, cfg: ModelConfig,
            ctx: Optional[ShardingCtx] = None) -> Tensor:
    """MoE FFN of x (B, S, D), with llama4's shared expert when the
    config has one. ``p`` holds ``router`` (D, E), ``w_gate``/``w_up``
    (E, D, F), ``w_down`` (E, F, D) and, shared, ``shared`` (an MLP).
    ``ctx``: the grid's EP paths (``moe_path``); the result is on x's
    device."""
    path = moe_path(x.shape[0], x.shape[1], cfg, ctx)
    path_counts[path] += 1
    if path == "a2a":
        y = _moe_ep_a2a(x, p, cfg, ctx)
    elif path == "replicated":
        y = _moe_ep_replicated(x, p, cfg, ctx)
    else:
        y = _moe_local(x, p, cfg)
    if cfg.shared_expert:
        y = y + swiglu(x, p.shared)
    return y
