#!/usr/bin/env python3
"""The LM mesh paths across cards against the same on logical devices.

    python3 tools/mesh_cards.py

Needs 4 CUDA cards. Each path runs twice in one process at smoke
size in f32 (seeded weights, chip_smoke.smoke_leaves): on a grid of
distinct cards (cards 0..n-1) and on a grid of the same shape made of
card 0 repeated (REPRO_TEST_DEVICES, as the CPU tests and chip_smoke.py
run it). The two must agree to 1e-6 relative (the same kernels on cards
of one model; the copies between cards change no value):

  * EP serving, olmoe-1b-7b on (data 2, model 2): the prefill's logits
    (``_moe_ep_a2a``) and a decode step's (``_moe_ep_replicated``), and
    every layer's expert group g laid out once on the cards of model
    index g (the decode reads the prefill's layout);
  * the sharded trainer (``jit_train_step``), olmoe-1b-7b on (2, 2): 3
    steps' loss and grad_norm, then the gathered parameters;
  * DDP (``make_ddp_train_step``), qwen3-14b on ("data",) of every card,
    plain and int8-compressed: 3 steps' loss, and every replica's
    parameters against the logical run's one replica;
  * ``gpipe_apply``, 4 qwen3-14b layers over a stage a card: the output
    and every parameter's gradient;
  * a checkpoint restored onto a (2, 2) grid of cards: each piece on its
    card, the whole equal to what was saved;
  * olmoe-1b-7b's train state restored onto (2, 2) through
    ``state_shardings``, and sharded from a whole state by
    ``shard_state``: each card holds exactly ``state_device_bytes`` of
    it (the pieces' storage, and ``torch.cuda.memory_allocated`` within
    the allocator's 512-byte rounding), and dropping the whole state
    frees it from card 0.

Prints the card, one JSON line per check ({"check", "max_rel", "ok"})
and exits 1 if any fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-6
CARDS = 4


def rel(torch, a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float((a - b).abs().max())


@contextlib.contextmanager
def logical(n: int):
    """REPRO_TEST_DEVICES=n (card 0 repeated n times) for the block."""
    os.environ["REPRO_TEST_DEVICES"] = str(n)
    try:
        yield
    finally:
        os.environ.pop("REPRO_TEST_DEVICES", None)


def serve(torch, np, smoke_leaves):
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.sharding.rules import make_ctx

    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              dtype=torch.float32)
    leaves = smoke_leaves(np, cfg, 0)
    x = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 16)), device="cuda:0")

    def run():
        params = lm_params_from_numpy(leaves, cfg, "cuda:0")
        ctx = make_ctx(make_host_mesh(2, "cuda"))
        moe.reset_paths()
        first, cache = prefill(params, {"tokens": x}, cfg, 24, ctx)
        layouts = [lp.moe.ep_layout[1] for lp in params.layers]
        step, _ = decode_step(params, x[:, -1:], cache, cfg, ctx=ctx)
        assert moe.path_counts == {"local": 0, "a2a": cfg.n_layers,
                                   "replicated": cfg.n_layers}, \
            moe.path_counts
        assert all(lp.moe.ep_layout[1] is lay
                   for lp, lay in zip(params.layers, layouts))
        return first, step, ctx, layouts

    first, step, ctx, layouts = run()
    assert len(set(ctx.grid.flat)) == 4, ctx.grid.flat
    for groups in layouts:
        for r, row in enumerate(ctx.shard_devices()):
            for g, dev in enumerate(row):
                assert all(w.device == dev for w in groups[(g, dev)]), \
                    (r, g, dev)
    with logical(4):
        first_l, step_l, _, _ = run()
    return max(rel(torch, first, first_l), rel(torch, step, step_l))


def train(torch, np, train_batch):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (gather_state, init_train_state,
                                              jit_train_step, shard_state,
                                              state_shardings)

    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              dtype=torch.float32)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = train_batch(np, cfg, 4, 32)

    def run():
        state = init_train_state(cfg, torch.Generator(
            device="cuda:0").manual_seed(0), "cuda:0")
        grid = make_host_mesh(2, "cuda")
        sh = state_shardings(grid, state, cfg)
        sharded = shard_state(state, sh)
        step = jit_train_step(cfg, opt, grid)
        metrics = []
        for _ in range(3):
            sharded, m = step(sharded, batch)
            metrics += [m["loss"], m["grad_norm"]]
        return metrics, gather_state(sharded, sh, "cuda:0")["params"]

    m_c, p_c = run()
    with logical(4):
        m_l, p_l = run()
    return max([rel(torch, a, b) for a, b in zip(m_c, m_l)]
               + [rel(torch, p_c[n], p_l[n]) for n in p_l])


def ddp(torch, np, train_batch, cards: int, compress: bool):
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (ddp_replicas, init_ddp_state,
                                              make_ddp_train_step)

    cfg = dataclasses.replace(get_config("qwen3-14b", smoke=True),
                              dtype=torch.float32)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = train_batch(np, cfg, 2 * cards, 16)

    def run():
        state = init_ddp_state(cfg, torch.Generator(
            device="cuda:0").manual_seed(0), "cuda:0")
        step = make_ddp_train_step(cfg, opt, compress=compress)
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(m["loss"])
        return losses, [dict(r["params"].named_parameters())
                        for r in ddp_replicas(state)]

    l_c, reps = run()
    assert len(reps) == cards, len(reps)
    with logical(cards):
        l_l, (one,) = run()
    return max([rel(torch, a, b) for a, b in zip(l_c, l_l)]
               + [rel(torch, r[n], one[n]) for r in reps for n in one])


def pipe(torch, cards: int):
    import repro_torch.models.model as mm
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import grid_of, visible_devices
    from repro_torch.models.attention import arange_positions
    from repro_torch.train.pipeline import gpipe_apply

    cfg = dataclasses.replace(get_config("qwen3-14b", smoke=True),
                              dtype=torch.float32, n_layers=cards)
    params = mm.trainable(mm.init_params(
        cfg, torch.Generator(device="cuda:0").manual_seed(0), "cuda:0"))
    gen = torch.Generator(device="cuda:0").manual_seed(3)
    x = torch.randn((4, 2, 32, cfg.d_model), generator=gen, device="cuda:0")

    def layer_fn(lp, h):
        return mm._layer_x(h, lp, cfg, arange_positions(2, 32, h.device), 0,
                           None, True, None)

    def run():
        grid = grid_of(visible_devices("cuda"), (cards,), ("pipe",))
        out = gpipe_apply(layer_fn, list(params.layers), x, grid)
        (out ** 2).sum().backward()
        grads = {n: p.grad for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return out.detach(), grads, grid

    out_c, g_c, grid = run()
    assert len(set(grid.flat)) == cards
    with logical(cards):
        out_l, g_l, _ = run()
    return max([rel(torch, out_c, out_l)]
               + [rel(torch, g_c[n], g_l[n]) for n in g_l
                  if g_l[n] is not None])


def restore(torch):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import Sharding

    w = torch.arange(64, dtype=torch.float32).view(8, 8)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=1)
        mgr.save(1, {"w": w})
        sh = Sharding(make_host_mesh(2, "cuda"), ("data", "model"))
        got = mgr.restore(1, {"w": ((8, 8), torch.float32)}, "cuda:0",
                          {"w": sh})["w"]
    devs = [p.device for p in got]
    assert devs == list(sh.grid.flat) and len(set(devs)) == 4, devs
    return rel(torch, sh.gather(got, "cpu"), w)


def state_bytes(torch):
    """Per-card bytes of olmoe-1b-7b's smoke train state on (2, 2), by
    restore and by shard_state, against state_device_bytes; 0.0 when
    every card holds exactly its share."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.train_step import (init_train_state, shard_state,
                                              state_device_bytes,
                                              state_shardings, state_tree)

    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              dtype=torch.float32)
    grid = make_host_mesh(2, "cuda")
    cards = list(grid.flat)

    def held(tree):
        """Bytes of distinct storage on each card, the int32 step left
        out (shard_state keeps it once, on the first card)."""
        seen, per = set(), [0] * len(cards)
        stack = [{k: v for k, v in tree["opt"].items() if k != "step"},
                 tree["params"]]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack += list(t.values())
            elif isinstance(t, list):
                stack += t
            elif t.untyped_storage().data_ptr() not in seen:
                seen.add(t.untyped_storage().data_ptr())
                per[cards.index(t.device)] += t.untyped_storage().nbytes()
        return per

    def alloc():
        return [torch.cuda.memory_allocated(d) for d in cards]

    want = [b - 4 for b in state_device_bytes(grid, cfg)]
    state = init_train_state(cfg, torch.Generator(
        device="cuda:0").manual_seed(0), "cuda:0")
    sh = state_shardings(grid, state, cfg)
    n_pieces = 4 * len(list(state["params"].parameters())) + 1
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=1)
        mgr.save(1, state_tree(state))
        before = alloc()
        restored = mgr.restore(1, state_tree(state), None, sh)
        grew = [a - b for a, b in zip(alloc(), before)]
    assert held(restored) == want, (held(restored), want)
    assert all(w <= g <= w + 4 + 512 * n_pieces
               for g, w in zip(grew, want)), (grew, want)
    del restored
    whole = held(state_tree(state))[0]
    sharded = shard_state(state, sh)
    assert held(sharded) == want, (held(sharded), want)
    before = alloc()[0]
    del state
    freed = before - alloc()[0]
    print(f"state bytes a card {want} (+4 the step), restore grew {grew}, "
          f"card 0 freed {freed} of {whole} dropping the whole state",
          file=sys.stderr)
    assert freed >= whole, (freed, whole)
    del sharded
    return 0.0


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    from chip_smoke import smoke_leaves, train_batch

    os.environ.pop("REPRO_TEST_DEVICES", None)
    if torch.cuda.device_count() < CARDS:
        print(f"mesh_cards: needs {CARDS} CUDA cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card.splitlines()[0], flush=True)
    import repro_torch.kernels.build as build
    build.build_all([n for n in build.SOURCES if n.startswith("flash")])
    checks = {
        "ep serve olmoe (2, 2)": lambda: serve(torch, np, smoke_leaves),
        "sharded train olmoe (2, 2)": lambda: train(torch, np, train_batch),
        "ddp plain qwen3 (4,)": lambda: ddp(torch, np, train_batch,
                                            CARDS, False),
        "ddp compressed qwen3 (4,)": lambda: ddp(torch, np, train_batch,
                                                 CARDS, True),
        "gpipe qwen3 4 stages": lambda: pipe(torch, CARDS),
        "restore onto (2, 2)": lambda: restore(torch),
        "state bytes a card (2, 2)": lambda: state_bytes(torch),
    }
    failed = 0
    for name, fn in checks.items():
        try:
            worst = fn()
            ok = worst <= TOL
            out = {"check": name, "max_rel": worst, "ok": ok}
        except Exception as exc:       # report every check, then fail
            ok = False
            out = {"check": name, "error": f"{type(exc).__name__}: {exc}"}
        failed += not ok
        print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
