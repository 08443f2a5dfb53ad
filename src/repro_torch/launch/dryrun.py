"""Dry run of every (arch x shape x grid) cell (port of
repro/launch/dryrun.py): trace one step on the meta device, count it, and
report per-device memory and a three-term H100 roofline, without running
anything and without a card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID|all]
        [--shape NAME|all] [--mesh single|multi|both] [--profile P]
        [--smoke] [--out results/dryrun_torch.json] [--resume]

The reference lowers and compiles each cell with XLA onto 256 or 512
forced host devices and parses the HLO. The port has no HLO: a cell's
step -- the ZeRO-3 train step (``train_step.jit_train_step``), ``prefill``
or ``decode_step`` on the model's ``ctx`` under the profile, or
``classify_windows`` for hog_svm_coproc -- runs once on meta tensors at
the cell's global shapes (``configs.input_specs``, ``cache_specs``),
under ``analysis/op_count.py``. The production grids
(``launch/mesh.py:production_layout``: 16x16 ("data", "model") and
2x16x16 ("pod", "data", "model")) are labels for the layouts: the dry run
makes them over as many meta devices as they need, and allocates
nothing on them.

Per-device numbers, and how each is derived:

  * FLOPs and HBM bytes: the traced step's totals (one device computing
    the whole global batch) divided by the grid's devices -- the
    reference's SPMD premise, "per-chip == global / chips"
    (repro/analysis/roofline.py). The step is traced on a one-device
    grid of the same axes, so the MoE takes its EP path with one shard
    (the same routing and capacity as the whole batch) and the profile's
    attention paths are the grid's. A train step that takes the "model"
    path on the grid (``models.model.grid_path``: every family where the
    "model" axis is larger than 1) is traced instead on one dp row of
    the grid's "model" axis (``model_row``) with the row's share of the
    global batch (B / dp): the sequence (and whisper's frames; hymba's
    meta tokens first) cut into that many chunks, each layer gathered
    onto every device of the row (one copy a device), K and V gathered,
    the flash forward and backward at each chunk's offset (non-causal
    over the encoder's chunks), the SSD's state handed across the
    chunks, the MoE's all-to-all over the row -- one dp row's work,
    divided by the row's devices (so each device counts its own gathered
    layer and head whole). Held against cards on (1, 4) alone (qwen3-14b
    40L, whisper, mamba2 24L, hymba 32L: tools/mesh_cards.py); the dp > 1
    grids are not measured. The row path's grids (a "model" axis of 1)
    run each dp row's dense work on the row's first device (the ZeRO-3
    rows, EP shards), so its busiest device does up to the "model" axis'
    size times this; the premise is kept so rows compare with the
    reference's.
  * argument bytes: exact per device, ``sharding/rules.py:device_bytes``
    over the plan's layouts -- ``state_shardings`` (train) or
    ``param_specs`` (serving), ``batch_specs`` and ``cache_specs_tree``,
    each fitted (``fit_tree``) -- the most any device holds; of the
    parameters, those some op of the step reads (a decode step reads no
    encoder weight), as ``jax.jit`` drops the arguments a step does not
    use.
  * alias bytes: what the step updates in place (the decode cache, the
    train state); output bytes: the step's results laid out likewise
    (prefill's cache by ``cache_specs_tree``, its logits over the dp
    axes); temp bytes: the trace's peak live bytes above its arguments,
    less what it made that outlives it (its outputs), over the devices; peak = argument + output
    + temp - alias, as the reference computes it.
  * collective bytes (``coll_detail``), on device 0 (a dp row's device
    and a block owner): the port has no collectives, only copies and sums
    in shard order between grid devices. In a train step
    (ZeRO-3), "param-gather": every parameter block the row does not
    hold, gathered onto the row's device (each layer twice: the forward
    and the recomputed backward), and "grad-sum": the other rows'
    gradient pieces of the blocks it owns. "ep-dispatch" / "ep-combine":
    the MoE's copies of capacity rows to and from the other expert
    groups (all-to-all path: prefill, and three times in a train step),
    or of a row's tokens to every group and back (replicated path:
    decode). Serving on a grid holds the model whole on a row's device
    (models/moe.py), so prefill and decode gather no parameters: their argument
    bytes are the plan's layout, which serving does not yet take.

Where the port reads a value on the host, the trace takes what the shape
set fixes, as the reference's lowering assumes: arange positions
(index-causal: M-RoPE's (B, S, 3) positions are an arange on the host,
so the flash route is taken as on real text); the decode cache's
``idx`` (a Python int) is seq_len - 1, the step decoding the last row of
a full cache.

``run_cell(..., grid=, batch=)`` also takes a grid and a batch from code:
chip_smoke.py predicts its one-card cells with it.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from ..analysis import op_count, roofline
from ..configs import (ARCH_IDS, SHAPE_BY_NAME, SHAPES, cache_specs,
                       get_config, input_specs, shape_applicable)
from ..launch.mesh import DeviceGrid, grid_of, production_layout
from ..models.configs import ModelConfig
from ..sharding.rules import (PROFILES, Sharding, batch_specs,
                              cache_specs_tree, device_bytes, dp_axes,
                              fit_tree, make_ctx, param_specs)

META = torch.device("meta")
DEFAULT_OUT = "results/dryrun_torch.json"
HOG_BATCH = 16384           # windows per 256 devices (the reference's)


class SkipCell(Exception):
    pass


def production_grid(multi_pod: bool) -> DeviceGrid:
    """``make_production_mesh``'s grid over meta devices: 16x16 or
    2x16x16."""
    shape, axes = production_layout(multi_pod)
    n = 1
    for d in shape:
        n *= d
    return grid_of((META,) * n, shape, axes)


def one_device(grid: DeviceGrid) -> DeviceGrid:
    """A grid of the same axes, each of size 1, on one meta device."""
    return grid_of((META,), (1,) * len(grid.axis_names), grid.axis_names)


def model_row(grid: DeviceGrid) -> DeviceGrid:
    """One dp row of ``grid``: the same axes, every one but "model" of
    size 1, on as many meta devices as "model" has."""
    sizes = tuple(grid.axis_sizes[a] if a == "model" else 1
                  for a in grid.axis_names)
    n = 1
    for s in sizes:
        n *= s
    return grid_of((META,) * n, sizes, grid.axis_names)


def mesh_label(grid: DeviceGrid) -> str:
    return "x".join(str(n) for n in grid.shape)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _shardings(specs: Dict[str, object], leaves: Dict[str, object],
               grid: DeviceGrid) -> Dict[str, Sharding]:
    fitted = fit_tree(specs, leaves, grid)
    return {k: Sharding(grid, sp) for k, sp in fitted.items()}


def most_bytes(shardings, leaves) -> int:
    """The most bytes any grid device holds of ``leaves`` laid out by
    ``shardings`` (``device_bytes``)."""
    per = device_bytes(shardings, leaves)
    return max(per) if per else 0


def _block_bytes(sh: Sharding, t) -> int:
    n = 1
    for d in sh.block_shape(tuple(t.shape)):
        n *= d
    return n * t.element_size()


def _batch_split(grid: DeviceGrid, B: int) -> int:
    """Into how many blocks a batch of B splits over the dp axes
    (``fit_spec``: an axis the batch does not divide by is dropped)."""
    dp = dp_axes(grid)
    spec = fit_tree({"b": (dp if len(dp) > 1 else dp[0],)}, {"b": (B,)},
                    grid)["b"]
    return Sharding(grid, spec).counts(1)[0]


def _host_positions(spec: torch.Tensor) -> torch.Tensor:
    """An arange of the positions' (B, S, 3) shape on the host: the
    index-causal positions the shape set assumes."""
    B, S = spec.shape[:2]
    return torch.arange(S, dtype=torch.int32).view(1, S, 1).expand(B, S, 3)


def _coll_detail(cfg: ModelConfig, kind: str, grid: DeviceGrid, B: int,
                 S: int, shapes: Dict[str, torch.Tensor],
                 sh: Dict[str, Sharding], ctx) -> Dict[str, float]:
    """The bytes device 0 receives from other grid devices in one step of
    B rows of S tokens (the module's docstring says what each kind is)."""
    if grid.size == 1:
        return {}
    out: Dict[str, float] = {}
    rows = ctx.dp_size
    if kind == "train":
        gather = 0
        for name, t in shapes.items():
            times = 2 if name.startswith(("layers.", "enc_layers.")) else 1
            gather += times * (_nbytes(t) - _block_bytes(sh[name], t))
        out["param-gather"] = float(gather)
        if rows > 1:
            own = sum(_block_bytes(sh[n], t) for n, t in shapes.items())
            out["grad-sum"] = float((rows - 1) * own)
    if cfg.is_moe:
        from ..models.moe import _capacity, moe_path
        ep = ctx.ep_size
        elt = torch.empty((), dtype=cfg.dtype).element_size()
        path = moe_path(B, S, cfg, ctx)
        per = 0.0
        if path == "a2a":
            T_l = (B // rows) * (S // ep)
            per = (cfg.n_experts * _capacity(T_l, cfg) * cfg.d_model * elt
                   * (ep - 1) / ep) * cfg.n_layers \
                * (3 if kind == "train" else 1)
        elif path == "replicated":
            per = (B // rows) * S * cfg.d_model * elt * (ep - 1) \
                * cfg.n_layers
        if per:
            out["ep-dispatch"] = out["ep-combine"] = float(per)
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               profile_name: str = "baseline", smoke: bool = False,
               grid: Optional[DeviceGrid] = None, batch: int = 0,
               seq_len: int = 0, layers: int = 0):
    """Build one cell's step on meta tensors, ready to trace (the
    reference's lower, without a compile) -> (step: a function of no
    arguments, cfg, grid, memory plan {argument, output and alias bytes a
    device}, coll_detail). ``grid`` in place of the production grid,
    ``batch`` of the shape's global batch, ``seq_len`` of its length and
    ``layers`` of the config's depth, where given."""
    profile = PROFILES[profile_name]
    shape = SHAPE_BY_NAME[shape_name]
    if seq_len:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    grid = production_grid(multi_pod) if grid is None else grid
    if arch == "hog_svm_coproc":
        return _lower_hog(grid, smoke, profile_name, batch)
    cfg = get_config(arch, smoke=smoke)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        raise SkipCell(reason)
    from ..models.model import decode_step, init_params, prefill

    specs = _input_specs(cfg, shape, smoke, batch)
    B = next(iter(specs.values())).shape[0]
    traced = grid.size
    ctx = make_ctx(grid, profile=profile)
    local = make_ctx(one_device(grid), profile=profile)
    batch_in = {k: (_host_positions(v) if k == "positions" else v)
                for k, v in specs.items()}
    if shape.kind == "train":
        from ..models.model import grid_path
        from ..train.optimizer import OptConfig
        from ..train.train_step import (init_train_state, jit_train_step,
                                        shard_state, state_shardings)
        g1 = one_device(grid)
        if grid_path(cfg, ctx) == "model":
            g1 = model_row(grid)
            # one dp row's share of the batch, counted on the row's devices
            traced = g1.size
            rows = grid.size // traced
            if B % rows:
                raise SkipCell(f"a batch of {B} does not split over {rows} "
                               f"dp rows")
            batch_in = {k: v[:B // rows] for k, v in batch_in.items()}
        plain = init_train_state(cfg, torch.Generator(), META)
        params = plain["params"]
        state = shard_state(plain, state_shardings(g1, plain, cfg))
        train = jit_train_step(cfg, OptConfig(), g1, profile)

        def step():
            return train(state, batch_in)
    else:
        params = init_params(cfg, torch.Generator(), META)
    shapes = dict(params.named_parameters())
    mem, p_sh, cache = _plan(cfg, shape, smoke, grid, profile, specs, shapes)
    if shape.kind == "prefill":
        def step():
            return prefill(params, batch_in, cfg, shape.seq_len, ctx=local)
    elif shape.kind == "decode":
        dctx = dataclasses.replace(local, seq_sharded=False)
        enc = specs.get("enc_states")

        def step():
            return decode_step(params, specs["token"], cache, cfg, enc=enc,
                               ctx=dctx)
    # the parameters' bytes, counted once the trace shows which it reads
    mem["params"] = (p_sh, shapes)
    mem["traced_devices"] = traced
    decode = shape.kind == "decode"
    S = 1 if decode else specs["tokens"].shape[1]
    coll = _coll_detail(cfg, shape.kind, grid, B, S, shapes, p_sh,
                        dataclasses.replace(
                            ctx, seq_sharded=ctx.seq_sharded and not decode))
    return step, cfg, grid, mem, coll


def _input_specs(cfg: ModelConfig, shape, smoke: bool, batch: int):
    specs = input_specs(cfg, shape, smoke=smoke)
    if batch:
        specs = {k: torch.empty((batch,) + tuple(v.shape[1:]),
                                dtype=v.dtype, device=META)
                 for k, v in specs.items()}
    return specs


def _plan(cfg: ModelConfig, shape, smoke: bool, grid: DeviceGrid, profile,
          specs: Dict[str, torch.Tensor], shapes: Dict[str, torch.Tensor]):
    """A cell's bytes a device, the parameters' aside -> ({"argument":
    the batch's, the cache's and the optimizer state's, "output",
    "alias"}, the parameters' shardings, the decode cache (meta, its idx
    seq_len - 1) or None)."""
    B = next(iter(specs.values())).shape[0]
    b_specs = {k: v for k, v in
               batch_specs(cfg, grid, shape.kind, profile).items()
               if k in specs}
    arg = most_bytes(_shardings(b_specs, specs, grid), specs)
    p_sh = _shardings(param_specs(shapes, cfg), shapes, grid)
    logits = B * cfg.vocab * torch.empty((), dtype=cfg.dtype).element_size()
    cache = None
    if shape.kind == "train":
        from ..train.train_step import state_device_bytes
        state_b = max(state_device_bytes(grid, cfg, shapes))
        # a new parameter comes from its f32 master: the parameters are
        # arguments only where the step reads them
        arg += state_b - most_bytes(p_sh, shapes)
        mem = {"argument": arg, "output": state_b + 12, "alias": state_b}
    elif shape.kind == "prefill":
        cache_shape = cache_specs(cfg, dataclasses.replace(
            shape, global_batch=B))
        cache_shape = {k: v for k, v in cache_shape.items() if k != "idx"}
        c_sh = _shardings({k: v for k, v in cache_specs_tree(
            cfg, grid, profile).items() if k in cache_shape},
            cache_shape, grid)
        mem = {"argument": arg, "alias": 0,
               "output": (most_bytes(c_sh, cache_shape)
                          + logits // _batch_split(grid, B))}
    else:
        cache = cache_specs(cfg, dataclasses.replace(shape, global_batch=B),
                            smoke=smoke)
        leaves = {k: (v if k != "idx" else ((), torch.int32))
                  for k, v in cache.items()}
        c_sh = {k: Sharding(grid, sp) for k, sp in fit_tree(
            cache_specs_tree(cfg, grid, profile),
            {k: (v if k != "idx" else ()) for k, v in cache.items()},
            grid).items()}
        cache_b = most_bytes(c_sh, leaves)
        cache["idx"] = (64 if smoke else shape.seq_len) - 1
        mem = {"argument": arg + cache_b, "alias": cache_b,
               "output": cache_b + logits // _batch_split(grid, B)}
    return mem, p_sh, cache


def argument_plan(arch: str, shape_name: str,
                  grid: Optional[DeviceGrid] = None,
                  profile_name: str = "baseline"):
    """A cell's argument bytes a device without a trace -> (the batch's,
    cache's and optimizer state's bytes, the parameters' shardings, the
    parameters (meta), by name): ``run_cell`` adds the bytes of the
    parameters its trace reads."""
    from ..models.model import param_shapes
    shape = SHAPE_BY_NAME[shape_name]
    grid = production_grid(False) if grid is None else grid
    cfg = get_config(arch)
    shapes = param_shapes(cfg)
    mem, p_sh, _ = _plan(cfg, shape, False, grid, PROFILES[profile_name],
                         _input_specs(cfg, shape, False, 0), shapes)
    return mem["argument"], p_sh, shapes


def _lower_hog(grid: DeviceGrid, smoke: bool, profile_name: str = "baseline",
               batch: int = 0):
    """The paper's co-processor at pod scale: batched window detection,
    data-parallel over every non-model axis (16,384 windows per 256
    devices)."""
    from ..core.hog import PAPER_HOG
    from ..core.pipeline import classify_windows
    hog_cfg = (PAPER_HOG if profile_name == "baseline"
               else dataclasses.replace(PAPER_HOG, feat_dtype="bf16"))
    B = batch or (64 if smoke else HOG_BATCH * max(1, grid.size // 256))
    params = {"w": torch.empty((3780,), dtype=torch.float32, device=META),
              "b": torch.empty((), dtype=torch.float32, device=META)}
    wins = torch.empty((B, 130, 66, 3), dtype=torch.uint8, device=META)
    dp = dp_axes(grid)
    sh = {"w": Sharding(grid, (None,)), "b": Sharding(grid, ()),
          "x": Sharding(grid, fit_tree({"x": (dp if len(dp) > 1 else dp[0],
                                              None, None, None)},
                                       {"x": wins}, grid)["x"])}
    arg = most_bytes(sh, {**params, "x": wins})
    # the scores (f32) and the verdicts (int32), split as the windows
    mem = {"argument": arg, "alias": 0,
           "output": 8 * B // _batch_split(grid, B)}

    def step():
        return classify_windows(params, wins, hog_cfg, path="ref")

    return step, _HogCfg, grid, mem, {}


class _HogCfg:  # roofline hooks for the non-LM workload
    name = "hog_svm_coproc"
    n_layers = 1

    @staticmethod
    def param_count(active_only=False):
        return 3781


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             profile: str = "baseline", smoke: bool = False,
             grid: Optional[DeviceGrid] = None, batch: int = 0,
             seq_len: int = 0, layers: int = 0) -> dict:
    """One cell's row, in the reference's format (launch/dryrun.py's
    docstring says how each number is derived); the overrides as
    ``lower_cell``'s."""
    t0 = time.time()
    shape = SHAPE_BY_NAME[shape_name]
    if seq_len:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    step, cfg, grid, mem, coll = lower_cell(arch, shape_name, multi_pod,
                                            profile, smoke, grid, batch,
                                            seq_len, layers)
    result, counts = op_count.count(step)
    t_lower = time.time() - t0
    n = mem.pop("traced_devices", grid.size)
    if "params" in mem:
        p_sh, named = mem.pop("params")
        used = {n: t for n, t in named.items()
                if op_count.storage_key(t) in counts["read"]}
        mem["argument"] += most_bytes({n: p_sh[n] for n in used}, used)
    temp = max(0, counts["peak_bytes"] - counts["live_bytes"]) // n
    del result
    mf = (roofline.model_flops(cfg, shape, grid.size, batch)
          if arch != "hog_svm_coproc" else 0.0)
    label = mesh_label(grid)
    rl = roofline.Roofline(
        name=f"{arch}/{shape_name}/{label}",
        flops_dev=counts["flops"] / n, mem_bytes_dev=counts["mem_bytes"] / n,
        coll_bytes_dev=float(sum(coll.values())), model_flops_dev=mf,
        cost_flops=counts["flops"], cost_bytes=counts["mem_bytes"])
    row = rl.row()
    row.update({
        "arch": arch, "shape": shape_name, "mesh": label,
        "profile": profile, "smoke": smoke, "batch": batch or None,
        "lower_s": round(t_lower, 1), "compile_s": 0.0,
        "mem": {
            "argument_bytes": mem["argument"],
            "output_bytes": mem["output"],
            "temp_bytes": temp,
            "alias_bytes": mem["alias"],
            "peak_bytes": (mem["argument"] + mem["output"] + temp
                           - mem["alias"]),
        },
        "coll_detail": coll,
        "cost_flops_raw": counts["flops"],
        "status": "ok",
    })
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id or 'all' (default: all + hog_svm_coproc)")
    ap.add_argument("--shape", default=None,
                    help="shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--profile", default="baseline",
                    choices=list(PROFILES.keys()))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already in --out")
    args = ap.parse_args(argv)

    archs = ([args.arch] if args.arch and args.arch != "all"
             else list(ARCH_IDS) + ["hog_svm_coproc"])
    shapes = ([args.shape] if args.shape and args.shape != "all"
              else [s.name for s in SHAPES])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        for shape_name in shapes:
            if arch == "hog_svm_coproc" and shape_name != "train_4k":
                continue   # coproc has one canonical detection shape
            for mp in meshes:
                key = (f"{arch}|{shape_name}|{'multi' if mp else 'single'}"
                       f"|{args.profile}")
                if args.resume and key in results and \
                        results[key].get("status") in ("ok", "skip"):
                    print(f"[cached] {key}")
                    continue
                print(f"[run] {key} ...", flush=True)
                mesh = "2x16x16" if mp else "16x16"
                try:
                    row = run_cell(arch, shape_name, mp, args.profile,
                                   args.smoke)
                    print(f"  ok: trace={row['lower_s']}s "
                          f"bottleneck={row['bottleneck']} "
                          f"step={row['step_time_s']:.4f}s "
                          f"peak={row['mem']['peak_bytes']/2**30:.2f}GiB",
                          flush=True)
                except SkipCell as e:
                    row = {"arch": arch, "shape": shape_name, "mesh": mesh,
                           "profile": args.profile,
                           "status": "skip", "reason": str(e)}
                    print(f"  skip: {e}", flush=True)
                except Exception as e:
                    row = {"arch": arch, "shape": shape_name, "mesh": mesh,
                           "profile": args.profile,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"  ERROR: {e!r}", flush=True)
                results[key] = row
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                gc.collect()
    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_skip = sum(1 for r in results.values() if r.get("status") == "skip")
    n_err = sum(1 for r in results.values() if r.get("status") == "error")
    print(f"done: {n_ok} ok, {n_skip} skip, {n_err} error")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
