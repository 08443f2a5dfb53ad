#!/usr/bin/env python3
"""The LM mesh paths across cards against the same on logical devices.

    python3 tools/mesh_cards.py [--out FILE] [--runs "NAME;..."]
                                [--what serve,prefill_32k,...]
                                [--no-dry | --dry-only]

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
  * the sharded trainer (``jit_train_step``) over "model" (the
    context-parallel step: each chunk's K and V gathered, its dK / dV
    summed in f32 on its card), olmoe-1b-7b on (2, 2), qwen3-14b,
    whisper-large-v3 (its encoder context-parallel over the frames),
    mamba2-130m and hymba-1.5b (the SSD's state handed across the
    cards) on (1, 4): 3 steps' loss and grad_norm, then the gathered
    parameters; the path counter must say "model"; and qwen3, whisper,
    mamba2 and hymba twice on the cards, equal bit for bit (each gathered
    layer's copies add their gradients into its pieces in model-index
    order: models/sharded.py ``gather_copies``);
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
    frees it from card 0;
  * serving from weights held as shards: olmoe-1b-7b on (2, 2) and
    qwen3-14b, whisper-large-v3, mamba2-130m and hymba-1.5b on (1, 4)
    over "model"
    (models/model.py's model path: context-parallel prefill and encoder,
    tensor-parallel decode on each card's own pieces, the cache's length
    over "model"; the path counter must say so), qwen2-vl-72b on (4, 1)
    (the row path), loaded per shard (``lm_params_from_numpy(...,
    shardings=)``): prefill and decode logits (whisper's encoder states)
    and ``generate(ctx=)``'s tokens; ``init_params(...,
    shardings=)`` per shard: each card's pieces and allocated bytes
    (``device_bytes``); 4,096 windows over 4 cards
    (``shard_over_data``) through ``kernel`` and ``fused`` against one
    card, bit for bit.

Then the models no card holds, at full width
and depth in bf16 from seeded weights made per shard (``FULL``), one
JSON line each ({"run", ...} or {"run", "error"}): qwen2-vl-72b (80
layers) on (1, 4) over "model" (serving B 4 x S 512 + 32 tokens, and a
prefill at 32,768 at B 1) and on (4, 1) (a dp row a card: B 4 x S 512 +
32, and prefills at 32,768, B 4), llama4-scout-17b-a16e (48 layers) on
(1, 4) over "model" and on (4, 1), serving and prefills at 32,768;
qwen3-14b's 40-layer ZeRO-3 step from a train state made per shard, on
(4, 1) at B 4 x S 512 and at train_4k, and on (1, 4) over "model" at B 4
x S 512 and at train_4k's length at B 1 (1,024 tokens a card), the path
counter read; whisper-large-v3 (32 + 32 layers) on (1, 4) over "model"
and on (4, 1), serving (its 1,500 seeded frames encoded first) and
ZeRO-3 steps at B 4 x S 512; mamba2-130m (24 layers) and hymba-1.5b (32,
under the ``perf`` profile) on (1, 4) over "model", serving and prefills
at 32,768 and 524,288 at B 1. ``--runs`` picks runs by name, ``--what``
their parts. For each: every card's ``memory_allocated``
after init against its ``device_bytes``; card 0's init peak against its
pieces plus its largest leaf's draw (f32, then the bf16 cast); the
pieces against the whole init's, leaf by leaf, bit for bit; over
"model", the cache made alone (``init_cache(ctx=)``): each card's
allocated bytes against the ``device_bytes`` of its fitted pieces; the
path the serving calls took; prefill S against prefill S - 1 plus a
``decode_step`` (5e-2 relative L2; a MoE's route flips at the last
token must be near-ties, pinned as chip_smoke.py's phase 5e does); each
card's peak beside the dry run's (launch/dryrun.py ``run_cell`` on a
grid of 4, computed in a process of its own on the host while the cards
run; ``--no-dry`` leaves it out, ``--dry-only`` computes it alone, with
no card, for the runs named); ms on the host clock. ``--out FILE``
writes everything there too, as JSON.

Prints the card, one JSON line per check ({"check", "max_rel", "ok"})
and exits 1 if any fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

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


def _train_run(torch, np, train_batch, arch: str, model: int):
    """run() -> 3 sharded steps' (loss, grad_norm) and the gathered
    parameters, on the cards' grid or, under ``logical``, card 0's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (gather_state, init_train_state,
                                              jit_train_step, shard_state,
                                              state_shardings)

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = train_batch(np, cfg, 4, 32)

    def run():
        state = init_train_state(cfg, torch.Generator(
            device="cuda:0").manual_seed(0), "cuda:0")
        grid = make_host_mesh(model, "cuda")
        sh = state_shardings(grid, state, cfg)
        sharded = shard_state(state, sh)
        step = jit_train_step(cfg, opt, grid)
        metrics = []
        lm.reset_paths()
        for _ in range(3):
            sharded, m = step(sharded, batch)
            metrics += [m["loss"], m["grad_norm"]]
        assert lm.path_counts["model" if model > 1 else "rows"] == 3, \
            lm.path_counts
        return metrics, gather_state(sharded, sh, "cuda:0")["params"]
    return run


def train(torch, np, train_batch, arch: str, model: int):
    """The sharded steps on the cards against card 0's logical devices."""
    run = _train_run(torch, np, train_batch, arch, model)
    m_c, p_c = run()
    with logical(4):
        m_l, p_l = run()
    return max([rel(torch, a, b) for a, b in zip(m_c, m_l)]
               + [rel(torch, p_c[n], p_l[n]) for n in p_l])


def train_twice(torch, np, train_batch, arch: str, model: int):
    """Two runs of the sharded steps on the cards: 0.0 where every loss,
    grad norm and parameter is equal bit for bit, else the largest
    relative difference (the check's tolerance is 0)."""
    run = _train_run(torch, np, train_batch, arch, model)
    (m_a, p_a), (m_b, p_b) = run(), run()
    same = all(torch.equal(a, b) for a, b in zip(m_a, m_b)) and all(
        torch.equal(p_a[n], p_b[n]) for n in p_a)
    return 0.0 if same else max(
        [rel(torch, a, b) for a, b in zip(m_a, m_b)]
        + [rel(torch, p_a[n], p_b[n]) for n in p_a] + [1e-30])


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


def shard_serve(torch, np, smoke_leaves, arch, model):
    """A model loaded per shard onto a (data, model) grid of the 4 cards
    and of card 0 repeated: prefill and decode logits and generate's
    tokens; each piece on its card, and (a MoE) each expert group on the
    cards of its model index."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.model import decode_step, encode, prefill
    from repro_torch.serve.engine import generate
    from repro_torch.sharding.rules import make_ctx, param_shardings

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    leaves = smoke_leaves(np, cfg, 0)
    x = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 16)), device="cuda:0")
    batch = {"tokens": x}
    if cfg.mrope:
        batch["positions"] = np.broadcast_to(
            np.arange(16)[None, :, None], (4, 16, 3)).copy()
    frames = None
    if cfg.encoder_layers:
        frames = np.random.default_rng(2).standard_normal(
            (4, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
        batch["enc_input"] = frames

    def run():
        from repro_torch.models import model as lm
        grid = make_host_mesh(model, "cuda")
        ctx = make_ctx(grid)
        params = lm_params_from_numpy(leaves, cfg, "cuda", param_shardings(
            grid, lm.param_shapes(cfg), cfg))
        for n, pieces in params.pieces.items():
            assert [p.device for p in pieces] == list(grid.flat), n
        moe.reset_paths()
        lm.reset_paths()
        first, cache = prefill(params, batch, cfg, 24, ctx)
        want = "model" if model > 1 else "rows"
        assert lm.path_counts[want] == 1, lm.path_counts
        if cfg.is_moe:
            assert moe.path_counts["a2a"] == cfg.n_layers * grid.shape[0], \
                moe.path_counts
        enc = None if frames is None else encode(params, frames, cfg, ctx)
        step, _ = decode_step(params, x[:, -1:], cache, cfg, enc=enc,
                              ctx=ctx)
        toks = generate(params, cfg, x, 4, ctx=ctx, enc_input=frames) \
            if not cfg.mrope else first.argmax(-1)
        return first, step, toks, grid, enc

    first, step, toks, grid, enc = run()
    assert len(set(grid.flat)) == 4, grid.flat
    with logical(4):
        first_l, step_l, toks_l, _, enc_l = run()
    assert torch.equal(toks.cpu(), toks_l.cpu())
    return max([rel(torch, first, first_l), rel(torch, step, step_l)]
               + ([] if enc is None else [rel(torch, enc, enc_l)]))


def shard_init(torch):
    """olmoe-1b-7b's init per shard on (2, 2) cards against the same on
    card 0 repeated: the pieces equal, each on its card, and each card's
    allocated bytes grown by its device_bytes (the allocator's rounding
    aside)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import init_params, param_shapes
    from repro_torch.sharding.rules import device_bytes, param_shardings

    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              dtype=torch.float32)

    def run():
        grid = make_host_mesh(2, "cuda")
        sh = param_shardings(grid, param_shapes(cfg), cfg)
        devs = list(dict.fromkeys(grid.flat))
        # the earlier checks' garbage goes first, and none is collected
        # while the bytes are counted
        gc.collect()
        gc.disable()
        try:
            sync(torch)
            before = [torch.cuda.memory_allocated(d) for d in devs]
            model = init_params(cfg, torch.Generator(device="cuda:0")
                                .manual_seed(0), "cuda:0", sh)
            sync(torch)
            grew = [torch.cuda.memory_allocated(d) - b
                    for d, b in zip(devs, before)]
        finally:
            gc.enable()
        return model, grid, sh, grew

    model, grid, sh, grew = run()
    want = device_bytes(sh, param_shapes(cfg))
    n = len(sh)
    assert all(w <= g <= w + 512 * n for g, w in zip(grew, want)), \
        (grew, want)
    with logical(4):
        one, _, _, _ = run()
    worst = 0.0
    for name, pieces in model.pieces.items():
        for a, b in zip(pieces, one.pieces[name]):
            worst = max(worst, float((a.cpu() - b.cpu()).abs().max()))
    print(f"shard init olmoe (2, 2): bytes a card {want}, allocated "
          f"{grew}", file=sys.stderr)
    return worst


def windows_cards(torch, np):
    """4,096 seeded windows over the 4 cards through kernel and fused
    against one card, bit for bit (0.0 when equal)."""
    import repro_torch.api as api
    import repro_torch.core.pipeline as pipe
    from repro_torch.launch.mesh import make_host_mesh

    g = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")
    svm = {"w": g["svm_w"], "b": np.asarray(g["svm_b"], np.float32)}
    wins = np.random.default_rng(7).integers(
        0, 256, (4096, 130, 66, 3)).astype(np.uint8)
    placed = pipe.shard_over_data(make_host_mesh(1, "cuda"), wins)
    assert len({p.device for p in placed.pieces}) == 4
    worst = 0.0
    for preset, path in (("paper", "kernel"), ("perf", "fused")):
        cfg = api.presets(preset).hog
        got = pipe.classify_windows(svm, placed, cfg, path)
        one = pipe.classify_windows(svm, wins, cfg, path, device="cuda:0")
        if not (torch.equal(got["score"], one["score"])
                and torch.equal(got["human"], one["human"])):
            worst = max(worst, rel(torch, got["score"], one["score"]), 1.0)
    return worst


# ------------------------------------------------- full width and depth

#: (run, arch, layers, grid (data, model), what): serving B 4 x S 512 +
#: 32 tokens and its S vs S - 1 + decode check, or a prefill at 32,768;
#: the ZeRO-3 steps at B 4 x S 512 and at train_4k
FULL = (("qwen2-vl 80L (1, 4)", "qwen2-vl-72b", 0, (1, 4),
         ("serve", "prefill_32k_b1")),
        ("qwen2-vl 80L (4, 1)", "qwen2-vl-72b", 0, (4, 1),
         ("serve", "prefill_32k")),
        ("llama4-scout 48L (1, 4)", "llama4-scout-17b-a16e", 0, (1, 4),
         ("serve",)),
        ("llama4-scout 48L (4, 1)", "llama4-scout-17b-a16e", 0, (4, 1),
         ("prefill_32k",)),
        ("qwen3-14b 40L ZeRO-3 (4, 1)", "qwen3-14b", 0, (4, 1),
         ("train", "train_4k")),
        ("qwen3-14b 40L ZeRO-3 (1, 4) model", "qwen3-14b", 0, (1, 4),
         ("train", "train_4k_b1")),
        ("whisper 32+32L (1, 4) model", "whisper-large-v3", 0, (1, 4),
         ("serve",)),
        ("whisper 32+32L (4, 1)", "whisper-large-v3", 0, (4, 1),
         ("serve",)),
        ("whisper 32+32L ZeRO-3 (1, 4) model", "whisper-large-v3", 0,
         (1, 4), ("train",)),
        ("whisper 32+32L ZeRO-3 (4, 1)", "whisper-large-v3", 0, (4, 1),
         ("train",)),
        ("mamba2 24L (1, 4) model", "mamba2-130m", 0, (1, 4),
         ("serve", "prefill_32k_b1", "prefill_500k_b1")),
        ("hymba 32L (1, 4) model perf", "hymba-1.5b", 0, (1, 4),
         ("serve", "prefill_32k_b1", "prefill_500k_b1")))
# a run's profile where it is not the baseline (sharding/rules.py
# PROFILES): hymba's windows banded, as chip_smoke.py's phase 5e runs it
RUN_PROFILE = {"hymba 32L (1, 4) model perf": "perf"}
SERVE = (4, 512, 32)
LONG = (4, 32768)
LONG_500K = 524288
TRAIN = (4, 512, 3)
TRAIN_4K = (4, 4096, 2)
TRAIN_4K_B1 = (1, 4096, 2)
# AdamW's rate for the 40-layer steps: chip_smoke.py's 1e-4 (4 layers)
# overshot at the third step at 40 (12.96 -> 6.56 -> 14.48), 3e-4 more
TRAIN_LR = 3e-5
CONSIST_TOL = 5e-2
# a MoE's capacity factor at 32,768: at its own 1.25 llama4-scout dropped
# 36,516 choices a prefill, 6 of them a last token's (pinned in the
# decode, which never drops); E / k (16) would hold every token at 8x
# the buffers
LONG_CF = 2.0
# the dry run's cells (arch, shape, grid, seq_len or 0, batch[, profile]),
# run in a process of its own beside the cards
DRY = (("qwen2-vl-72b", "prefill_32k", (1, 4), 512, 4),
       ("qwen2-vl-72b", "decode_32k", (1, 4), 544, 4),
       ("qwen2-vl-72b", "prefill_32k", (1, 4), 0, 1),
       ("qwen2-vl-72b", "prefill_32k", (4, 1), 512, 4),
       ("qwen2-vl-72b", "prefill_32k", (4, 1), 0, 4),
       ("llama4-scout-17b-a16e", "prefill_32k", (1, 4), 512, 4),
       ("llama4-scout-17b-a16e", "decode_32k", (1, 4), 544, 4),
       ("llama4-scout-17b-a16e", "prefill_32k", (4, 1), 0, 4),
       ("qwen3-14b", "train_4k", (4, 1), 512, 4),
       ("qwen3-14b", "train_4k", (4, 1), 0, 4),
       ("qwen3-14b", "train_4k", (1, 4), 512, 4),
       ("qwen3-14b", "train_4k", (1, 4), 0, 1),
       ("whisper-large-v3", "prefill_32k", (1, 4), 512, 4),
       ("whisper-large-v3", "prefill_32k", (4, 1), 512, 4),
       ("whisper-large-v3", "train_4k", (1, 4), 512, 4),
       ("whisper-large-v3", "train_4k", (4, 1), 512, 4),
       ("mamba2-130m", "prefill_32k", (1, 4), 512, 4),
       ("mamba2-130m", "decode_32k", (1, 4), 544, 4),
       ("mamba2-130m", "prefill_32k", (1, 4), 0, 1),
       ("mamba2-130m", "prefill_32k", (1, 4), LONG_500K, 1),
       ("hymba-1.5b", "prefill_32k", (1, 4), 512, 4, "perf"),
       ("hymba-1.5b", "decode_32k", (1, 4), 544, 4, "perf"),
       ("hymba-1.5b", "prefill_32k", (1, 4), 0, 1, "perf"),
       ("hymba-1.5b", "prefill_32k", (1, 4), LONG_500K, 1, "perf"))
_DRY = r"""
import json, sys
import torch
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import grid_of
torch.set_num_threads(4)
out = {}
for arch, shape, grid, seq, batch, *profile in json.loads(sys.argv[1]):
    key = f"{arch} {shape} {tuple(grid)} {seq} B{batch}" + "".join(
        f" {p}" for p in profile)
    try:
        g = grid_of((torch.device("meta"),) * 4, tuple(grid),
                    ("data", "model"))
        r = run_cell(arch, shape, profile=(profile or ["baseline"])[0],
                     grid=g, batch=batch, seq_len=seq)
        out[key] = {"peak_gib": r["mem"]["peak_bytes"] / 2 ** 30,
                    "argument_gib": r["mem"]["argument_bytes"] / 2 ** 30,
                    "step_ms": r["step_time_s"] * 1e3}
    except Exception as e:
        out[key] = {"error": repr(e)[:300]}
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)
"""


def start_dry(out: pathlib.Path, runs):
    """The dry run's cells of the archs in ``runs``, in a process of its
    own that sees no card."""
    archs = {r[1] for r in runs}
    cells = [c for c in DRY if c[0] in archs]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-c", _DRY, json.dumps(cells), str(out)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def gib(n) -> float:
    return round(n / 2 ** 30, 3)


def cards_state(torch):
    return [gib(torch.cuda.memory_allocated(i)) for i in range(CARDS)]


def peaks(torch):
    return [gib(torch.cuda.max_memory_allocated(i)) for i in range(CARDS)]


def reset_peaks(torch):
    for i in range(CARDS):
        torch.cuda.synchronize(i)
        torch.cuda.reset_peak_memory_stats(i)


def sync(torch):
    for i in range(CARDS):
        torch.cuda.synchronize(i)


def made_per_shard(torch, cfg, grid, train: bool):
    """The model (or train state) made per shard, with each card's
    allocated bytes after it against device_bytes, card 0's init peak
    against its pieces plus its largest leaf's draw, and the pieces
    against the whole init's, leaf by leaf. -> (model or state,
    record)."""
    from repro_torch.models.model import (_init_leaves, init_params,
                                          param_shapes)
    from repro_torch.models.sharded import shard_leaf
    from repro_torch.sharding.rules import device_bytes, param_shardings
    from repro_torch.train.train_step import (init_train_state,
                                              state_device_bytes,
                                              state_shardings)

    shapes = param_shapes(cfg)
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    gc.collect()                 # the last run's garbage first
    sync(torch)
    base = [torch.cuda.memory_allocated(i) for i in range(CARDS)]
    reset_peaks(torch)
    t0 = time.perf_counter()
    if train:
        sh = state_shardings(grid, {"params": shapes}, cfg)
        made = init_train_state(cfg, gen, "cuda:0", shardings=sh)
        psh, pieces = sh["params"], made["params"]
        # the int32 step lies on the grid's first card alone
        want = [b - 4 * (i > 0) for i, b in
                enumerate(state_device_bytes(grid, cfg, shapes))]
    else:
        psh = param_shardings(grid, shapes, cfg)
        made = init_params(cfg, gen, "cuda:0", psh)
        pieces = made.pieces
        want = device_bytes(psh, shapes)
    sync(torch)
    secs = time.perf_counter() - t0
    got = [torch.cuda.memory_allocated(i) - b for i, b in enumerate(base)]
    init_peak = torch.cuda.max_memory_allocated(0) - base[0]
    leaf = max(t.numel() for t in shapes.values())
    rec = {"init_s": round(secs, 2), "allocated_before_gib":
           [gib(b) for b in base], "device_bytes_gib": [gib(w) for w in want],
           "allocated_gib": [gib(g) for g in got],
           "init_peak_card0_gib": gib(init_peak),
           "largest_leaf_gib": gib(leaf * 2),
           "card0_bound_gib": gib(want[0] + leaf * 6)}
    # each allocation rounds up to 512 bytes, and a large block keeps a
    # remainder under 1 MiB unsplit: at most that a piece
    rec["allocated_minus_device_bytes_mib"] = [
        round((g - w) / 2 ** 20, 2) for g, w in zip(got, want)]
    n_alloc = (4 if train else 1) * len(shapes)
    rec["allocated_eq_device_bytes"] = all(
        w <= g <= w + 2 ** 20 * n_alloc for g, w in zip(got, want))
    rec["init_peak_ok"] = init_peak <= want[0] + leaf * 6 + 2 ** 20
    # bit for bit against the whole init, one leaf at a time
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    same = True
    for name, t in _init_leaves(cfg, gen, torch.device("cuda:0")):
        w = shard_leaf(psh[name], t)
        same &= all(torch.equal(a, b) for a, b in zip(pieces[name], w))
        del t, w
    rec["pieces_eq_whole_init"] = bool(same)
    return made, rec


def timed(torch, fn):
    sync(torch)
    t0 = time.perf_counter()
    out = fn()
    sync(torch)
    return out, (time.perf_counter() - t0) * 1e3


class LastRoutes:
    """The MoE routing of each batch row's last token, layer by layer,
    through the grid's expert paths: ``record`` wraps a prefill of (B, S)
    over ``rows`` dp rows and ``ep`` expert groups (the all-to-all path:
    each (row, group) call routes the row's Bl x S / ep tokens, the last
    tokens in the last group's call), ``pin`` a decode step (each (row,
    group) call routes the row's Bl tokens), forcing each row's top-k
    experts to the prefill's and reporting where they differed and
    whether each was a near-tie (chip_smoke.py's route_flips test: the
    prefill's gap between its k-th and (k+1)-th gate within twice the
    largest gate difference)."""

    def __init__(self, torch, rows: int, ep: int, B: int, S: int, k: int):
        self.torch, self.rows, self.ep, self.k = torch, rows, ep, k
        self.Bl, self.Sl = B // rows, S // ep
        self.gates = {}              # (layer, batch row) -> f32 (E,)
        self.drops = {}              # (layer, batch row) -> bool (k,)
        self.flips = self.ties = 0

    def _where(self, c: int):
        """(layer, row, group) of top-k call c: models/moe.py's
        _shard_route takes the top-k twice (in _route, then for the
        combine), (row, group) calls in row-major order a layer."""
        c //= 2
        return c // (self.rows * self.ep), (c // self.ep) % self.rows, \
            c % self.ep

    def _wrap(self, fn, hook):
        import repro_torch.models.moe as moe
        top_k, count = moe._top_k, [0]

        def wrapped(gates, k):
            w, idx = top_k(gates, k)
            out = hook(count[0], gates, w, idx)
            count[0] += 1
            return out
        moe._top_k = wrapped
        try:
            return fn()
        finally:
            moe._top_k = top_k

    def record(self, fn):
        def hook(c, gates, w, idx):
            layer, r, g = self._where(c)
            if g == self.ep - 1:
                for b in range(self.Bl):
                    self.gates[(layer, r * self.Bl + b)] = \
                        gates[b * self.Sl + self.Sl - 1].float().clone()
            return w, idx
        return self._wrap(fn, hook)

    def set_drops(self, calls) -> int:
        """The prefill's dropped choices of each row's last token, from
        chip_smoke.moe_drops's calls (one a (layer, row, group) route, in
        _where's order) -> how many."""
        self.drops = {}
        for i, c in enumerate(calls):
            layer, r, g = self._where(2 * i)
            if g == self.ep - 1:
                last = c.view(self.Bl, self.Sl, self.k)[:, -1]
                for b in range(self.Bl):
                    self.drops[(layer, r * self.Bl + b)] = last[b].clone()
        return int(sum(int(d.sum()) for d in self.drops.values()))

    def pin(self, fn, count: bool):
        """``fn()`` with each row's experts set to the prefill's, and the
        choices the prefill dropped dropped too (a decode step's capacity
        never fills)."""
        import repro_torch.models.moe as moe
        torch = self.torch
        route, n = moe._route, [0]

        def dropping(x_flat, gates, cfg, capacity):
            buf, tok, slot, w = route(x_flat, gates, cfg, capacity)
            layer, r, _ = self._where(2 * n[0])
            n[0] += 1
            slot = slot.clone().view(self.Bl, self.k)
            for b in range(self.Bl):
                d = self.drops.get((layer, r * self.Bl + b))
                if d is not None:
                    slot[b][d.to(slot.device)] = capacity
            return buf, tok, slot.view(-1), w
        moe._route = dropping
        try:
            return self._pin_routes(fn, count)
        finally:
            moe._route = route

    def _pin_routes(self, fn, count: bool):
        torch = self.torch

        def hook(c, gates, w, idx):
            layer, r, g = self._where(c)
            w, idx = w.clone(), idx.clone()
            for b in range(self.Bl):
                want = self.gates[(layer, r * self.Bl + b)].to(gates.device)
                choice = torch.sort(want, descending=True,
                                    stable=True)[1][:self.k]
                if count and g == 0 and c % 2 == 0 and \
                        set(idx[b].tolist()) != \
                        set(choice.tolist()):
                    self.flips += 1
                    sw = torch.sort(want, descending=True)[0]
                    self.ties += float(sw[self.k - 1] - sw[self.k]) <= \
                        2 * float((gates[b].float() - want).abs().max())
                idx[b] = choice
                w[b] = gates[b, choice]
            return w, idx
        return self._wrap(fn, hook)


def consistency(torch, chip, model, cfg, x, ctx, positions=None, enc=None):
    """prefill S's last logits against prefill S - 1 + decode_step, each
    row's (whisper's both over the encoder states ``enc``); a MoE's last
    tokens: their dropped choices counted, and the decode's experts
    pinned to the prefill's (LastRoutes), where every route that differed
    must be a near-tie, and the choices the prefill dropped dropped in
    the decode too. -> record."""
    from repro_torch.models.model import decode_step, prefill

    S = x.shape[1]
    full, part = {"tokens": x}, {"tokens": x[:, :-1]}
    if positions is not None:
        full["positions"], part["positions"] = positions, positions[:, :-1]
    rec = {}
    if cfg.is_moe:
        rows, ep = ctx.dp_size, ctx.ep_size
        routes = LastRoutes(torch, rows, ep, x.shape[0], S, cfg.top_k)
        (out, calls), ms = timed(torch, lambda: chip.moe_drops(
            torch, lambda: routes.record(
                lambda: prefill(model, full, cfg, S, ctx)[0])))
        rec["capacity_factor"] = cfg.capacity_factor
        rec["drops"] = int(sum(int(c.sum()) for c in calls))
        rec["last_token_drops_pinned"] = routes.set_drops(calls)
    else:
        out, ms = timed(torch, lambda: prefill(model, full, cfg, S, ctx,
                                               enc=enc)[0])
    rec["prefill_ms"] = round(ms, 1)
    a = out[:, -1].float()
    del out
    (_, cache), ms = timed(torch, lambda: prefill(model, part, cfg, S, ctx,
                                                  enc=enc))
    rec["prefill_s_minus_1_ms"] = round(ms, 1)

    def step():
        return decode_step(model, x[:, -1:], cache, cfg, enc=enc,
                           ctx=ctx)[0]
    if cfg.is_moe:
        b, ms = timed(torch, lambda: routes.pin(step, True))
        rec["route_flips"], rec["near_ties"] = routes.flips, routes.ties
        rec["unpinned_rel_l2"] = float(
            (a - step()[:, -1].float()).norm() / a.norm())
    else:
        b, ms = timed(torch, step)
    rec["decode_ms"] = round(ms, 1)
    r = float((a - b[:, -1].float().to(a.device)).norm() / a.norm())
    rec["rel_l2"] = r
    rec["consistent"] = (bool(torch.isfinite(a).all()) and r <= CONSIST_TOL
                         and rec.get("route_flips", 0)
                         == rec.get("near_ties", 0))
    return rec


def cache_bytes(torch, cfg, ctx, B: int, max_len: int) -> dict:
    """The cache of a serving call over "model" made alone
    (``init_cache(ctx=)``): each card's allocated bytes against the
    ``device_bytes`` of its fitted pieces, and the specs."""
    from repro_torch.models.model import cache_shapes, init_cache
    from repro_torch.sharding.rules import device_bytes

    gc.collect()
    sync(torch)
    base = [torch.cuda.memory_allocated(i) for i in range(CARDS)]
    cache = init_cache(cfg, B, max_len, ctx=ctx)
    sync(torch)
    got = [torch.cuda.memory_allocated(i) - b for i, b in enumerate(base)]
    want = device_bytes(cache["shardings"], cache_shapes(cfg, B, max_len))
    rec = {"specs": {k: str(sh.spec) for k, sh in
                     cache["shardings"].items()},
           "device_bytes_gib": [gib(w) for w in want],
           "allocated_gib": [gib(g) for g in got],
           "allocated_eq_device_bytes": all(
               w <= g <= w + 2 ** 20 * len(want) for g, w in
               zip(got, want))}
    del cache
    return rec


def serve_full(torch, np, chip, model, cfg, ctx):
    """B 4 x S 512 + 32 greedy tokens through prefill and decode_step
    (prefill ms, decode ms a step; over "model" the cache's bytes a card
    first, and the path the calls took), then the S vs S - 1 + decode
    check (a MoE at capacity factor E / k, where nothing drops).
    Whisper: its states from ``encode`` of 1,500 seeded frames (encode
    ms), read by the prefill and every decode step."""
    from repro_torch.models import model as lm
    from repro_torch.models.model import decode_step, encode, prefill

    B, S, new = SERVE
    path = lm.serve_path(model, cfg, ctx)
    pre = {"path": path}
    if path == "model":
        pre["cache"] = cache_bytes(torch, cfg, ctx, B, S + new)
    lm.reset_paths()
    x = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)), device="cuda:0")
    pos = (np.broadcast_to(np.arange(S)[None, :, None], (B, S, 3)).copy()
           if cfg.mrope else None)
    batch = {"tokens": x} if pos is None else {"tokens": x,
                                               "positions": pos}
    enc = None
    if cfg.encoder_layers:
        frames = np.random.default_rng(4).standard_normal(
            (B, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
        enc, pre["encode_ms"] = timed(
            torch, lambda: encode(model, frames, cfg, ctx))
        pre["encode_ms"] = round(pre["encode_ms"], 1)
    (logits, cache), pre_ms = timed(
        torch, lambda: prefill(model, batch, cfg, S + new, ctx, enc=enc))
    toks = [logits[:, -1].argmax(-1, keepdim=True)]
    sync(torch)
    t0 = time.perf_counter()
    for _ in range(new - 1):
        logits, cache = decode_step(model, toks[-1], cache, cfg, enc=enc,
                                    ctx=ctx)
        toks.append(logits[:, -1].argmax(-1, keepdim=True))
    sync(torch)
    dec_ms = (time.perf_counter() - t0) * 1e3 / (new - 1)
    rec = {**pre, "prefill_ms": round(pre_ms, 1),
           "decode_ms_step": round(dec_ms, 1),
           "finite": bool(torch.isfinite(logits).all()),
           "path_counts": dict(lm.path_counts)}
    del cache, logits
    ccfg = (dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                / cfg.top_k) if cfg.is_moe else cfg)
    rec["check"] = consistency(torch, chip, model, ccfg, x, ctx, pos, enc)
    return rec


def long_prefill(torch, np, chip, model, cfg, ctx, B: int = LONG[0],
                 S: int = LONG[1]):
    """Prefill at 32,768 (or S), B 4 (one row a card on (4, 1)) or ``B``,
    and the S vs S - 1 + decode check; a MoE at capacity factor LONG_CF
    (its last tokens' dropped choices pinned in the decode,
    LastRoutes)."""
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=LONG_CF)
    x = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)), device="cuda:0")
    pos = (np.broadcast_to(np.arange(S)[None, :, None], (B, S, 3)).copy()
           if cfg.mrope else None)
    return consistency(torch, chip, model, cfg, x, ctx, pos)


def train_full(torch, np, chip, state, cfg, grid, shape):
    """ZeRO-3 steps at (B, S, steps): the losses (falling), ms a step
    and the paths the steps took (models/model.py ``path_counts``)."""
    from repro_torch.models import model as lm
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import jit_train_step

    B, S, steps = shape
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    step = jit_train_step(cfg, opt, grid)
    batch = chip.train_batch(np, cfg, B, S)
    losses, ms = [], []
    lm.reset_paths()
    for _ in range(steps):
        (state, m), t = timed(torch, lambda: step(state, batch))
        losses.append(float(m["loss"]))
        ms.append(round(t, 1))
    return {"losses": losses, "ms_step": ms,
            "loss_falls": losses[-1] < losses[0],
            "paths": {k: v for k, v in lm.path_counts.items() if v}}


def full_width(torch, np, out, runs=FULL, parts=None):
    """Each of ``runs`` (FULL's), its record printed and kept in ``out``;
    ``parts``: only those of each run's parts. A run that fails (out of
    memory too) is recorded with what it reached."""
    import chip_smoke as chip
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import grid_of
    from repro_torch.sharding.rules import PROFILES, make_ctx

    cards = [torch.device("cuda", i) for i in range(CARDS)]
    for run, arch, layers, shape, what in runs:
        if parts is not None:
            what = tuple(w for w in what if w in parts)
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        grid = grid_of(cards, shape, ("data", "model"))
        ctx = make_ctx(grid, profile=PROFILES[RUN_PROFILE.get(run,
                                                              "baseline")])
        rec = {"run": run}
        made = None
        try:
            train = what[0] == "train"
            made, rec["init"] = made_per_shard(torch, cfg, grid, train)
            for w in what:
                reset_peaks(torch)
                if w == "serve":
                    r = serve_full(torch, np, chip, made, cfg, ctx)
                elif w.startswith("prefill_"):
                    r = long_prefill(torch, np, chip, made, cfg, ctx,
                                     1 if w.endswith("_b1") else LONG[0],
                                     LONG_500K if "500k" in w else LONG[1])
                else:
                    r = train_full(torch, np, chip, made, cfg, grid,
                                   {"train": TRAIN, "train_4k": TRAIN_4K,
                                    "train_4k_b1": TRAIN_4K_B1}[w])
                r["peak_gib"] = peaks(torch)
                rec[w] = r
        except Exception as exc:           # record it, go on to the next
            rec["error"] = f"{type(exc).__name__}: {str(exc)[:400]}"
            rec["peak_at_error_gib"] = peaks(torch)
        del made
        gc.collect()
        torch.cuda.empty_cache()
        rec["allocated_after_gib"] = cards_state(torch)
        out.append(rec)
        print(json.dumps(rec), flush=True)


def read_dry(dry, path: pathlib.Path) -> dict:
    """The dry run's predictions, once its process ends (at most 900 s)."""
    try:
        dry.wait(timeout=900)
    except subprocess.TimeoutExpired:
        dry.kill()
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {"error": dry.stderr.read()[-2000:] if dry.stderr
                else "no output"}


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    args = sys.argv[1:]
    out_json = args[args.index("--out") + 1] if "--out" in args else None
    runs = FULL
    if "--runs" in args:
        names = args[args.index("--runs") + 1].split(";")
        runs = tuple(r for r in FULL if r[0] in names)
        if len(runs) != len(names):
            print(f"mesh_cards: --runs takes names of {[r[0] for r in FULL]}",
                  file=sys.stderr)
            return 2
    parts = (args[args.index("--what") + 1].split(",") if "--what" in args
             else None)
    scratch = pathlib.Path(tempfile.mkdtemp())
    dry = None if "--no-dry" in args else start_dry(scratch / "dry.json",
                                                    runs)
    if "--dry-only" in args:
        predicted = read_dry(dry, scratch / "dry.json")
        shutil.rmtree(scratch, ignore_errors=True)
        print(json.dumps({"dry_run": predicted}), flush=True)
        if out_json:
            with open(out_json, "w") as f:
                json.dump({"dry_run": predicted}, f, indent=1)
        return 0
    import numpy as np
    import torch
    from chip_smoke import smoke_leaves, train_batch

    os.environ.pop("REPRO_TEST_DEVICES", None)
    if torch.cuda.device_count() < CARDS:
        print(f"mesh_cards: needs {CARDS} CUDA cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        if dry is not None:
            dry.kill()
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card.splitlines()[0], flush=True)
    import repro_torch.kernels.build as build
    build.build_all()
    checks = {
        "ep serve olmoe (2, 2)": lambda: serve(torch, np, smoke_leaves),
        "sharded train olmoe (2, 2)": lambda: train(
            torch, np, train_batch, "olmoe-1b-7b", 2),
        "sharded train qwen3 (1, 4) model": lambda: train(
            torch, np, train_batch, "qwen3-14b", 4),
        "ddp plain qwen3 (4,)": lambda: ddp(torch, np, train_batch,
                                            CARDS, False),
        "ddp compressed qwen3 (4,)": lambda: ddp(torch, np, train_batch,
                                                 CARDS, True),
        "gpipe qwen3 4 stages": lambda: pipe(torch, CARDS),
        "restore onto (2, 2)": lambda: restore(torch),
        "state bytes a card (2, 2)": lambda: state_bytes(torch),
        "shard serve olmoe (2, 2)": lambda: shard_serve(
            torch, np, smoke_leaves, "olmoe-1b-7b", 2),
        "shard serve qwen3 (1, 4)": lambda: shard_serve(
            torch, np, smoke_leaves, "qwen3-14b", 4),
        "shard serve qwen2-vl (4, 1)": lambda: shard_serve(
            torch, np, smoke_leaves, "qwen2-vl-72b", 1),
        "shard serve whisper (1, 4) model": lambda: shard_serve(
            torch, np, smoke_leaves, "whisper-large-v3", 4),
        "sharded train whisper (1, 4) model": lambda: train(
            torch, np, train_batch, "whisper-large-v3", 4),
        "sharded train qwen3 (1, 4) model, two card runs": lambda:
            train_twice(torch, np, train_batch, "qwen3-14b", 4),
        "sharded train whisper (1, 4) model, two card runs": lambda:
            train_twice(torch, np, train_batch, "whisper-large-v3", 4),
        "shard serve mamba2 (1, 4) model": lambda: shard_serve(
            torch, np, smoke_leaves, "mamba2-130m", 4),
        "shard serve hymba (1, 4) model": lambda: shard_serve(
            torch, np, smoke_leaves, "hymba-1.5b", 4),
        "sharded train mamba2 (1, 4) model": lambda: train(
            torch, np, train_batch, "mamba2-130m", 4),
        "sharded train hymba (1, 4) model": lambda: train(
            torch, np, train_batch, "hymba-1.5b", 4),
        "sharded train mamba2 (1, 4) model, two card runs": lambda:
            train_twice(torch, np, train_batch, "mamba2-130m", 4),
        "sharded train hymba (1, 4) model, two card runs": lambda:
            train_twice(torch, np, train_batch, "hymba-1.5b", 4),
        "shard init olmoe (2, 2)": lambda: shard_init(torch),
        "windows over 4 cards": lambda: windows_cards(torch, np),
    }
    failed = 0
    for name, fn in checks.items():
        try:
            worst = fn()
            ok = worst <= (0.0 if name.endswith("two card runs") else TOL)
            out = {"check": name, "max_rel": worst, "ok": ok}
        except Exception as exc:       # report every check, then fail
            ok = False
            out = {"check": name, "error": f"{type(exc).__name__}: {exc}"}
        failed += not ok
        print(json.dumps(out), flush=True)
    records = []
    t0 = time.perf_counter()
    full_width(torch, np, records, runs, parts)
    print(f"full width: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    predicted = (read_dry(dry, scratch / "dry.json") if dry is not None
                 else {"skipped": "--no-dry"})
    shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps({"dry_run": predicted}), flush=True)
    if out_json:
        with open(out_json, "w") as f:
            json.dump({"card": card, "runs": records, "dry_run": predicted},
                      f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
