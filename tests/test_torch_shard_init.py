"""Models and train states made and loaded per shard, on
REPRO_TEST_DEVICES=8 logical CPU devices, f32 at smoke size:

  * ``init_params(cfg, generator, shardings=param_shardings(...))`` for
    every arch on (4, 2) and (2, 2, 2): every piece equal, bit for bit,
    to ``Sharding.shard`` of the same leaf of the whole ``init_params``
    from the same seed, and ``param_shardings`` equal to the reference's
    specs fitted by ``fit_tree`` (as test_torch_sharding.py holds
    ``param_specs``);
  * ``init_train_state(..., shardings=state_shardings(...))``: equal, bit
    for bit, to ``shard_state(init_train_state(...))`` for every arch,
    and three ``jit_train_step`` steps from each give the same losses
    and parameters bit for bit;
  * ``lm_params_from_numpy(..., shardings=)`` and a checkpoint restored
    with ``param_shardings`` (``CheckpointManager.restore``): the same
    pieces, each its own storage, accepted as-is by ``prefill``,
    ``decode_step`` and ``generate``;
  * the faults a grid refuses: pieces off the grid, a batch that does not
    split over the dp rows, a cache without rows, another grid's ctx;
  * ``PipelineConfig.from_json``: ``to_json``'s inverse for every preset,
    and the reference's ``to_json`` text read as the port's preset.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import grid_of

N_DEV = 8
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
GRIDS = {"4x2": ((4, 2), ("data", "model")),
         "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("REPRO_TEST_DEVICES", str(N_DEV))


def _cfg(arch):
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32)


def _grid(name="4x2"):
    shape, axes = GRIDS[name]
    return grid_of((torch.device("cpu"),) * N_DEV, shape, axes)


def _gen():
    return torch.Generator().manual_seed(0)


def _cut(whole, shardings):
    """A whole model cut into its pieces (views of its leaves here)."""
    from repro_torch.models.sharded import ShardedLM, shard_leaf
    return ShardedLM(whole.cfg, shardings, {
        n: shard_leaf(shardings[n], t)
        for n, t in whole.named_parameters()})


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_shard_init_equals_the_whole_init_cut(arch, grid_name):
    from repro_torch.models.model import init_params, param_shapes
    from repro_torch.models.sharded import ShardedLM
    from repro_torch.sharding.rules import (fit_tree, param_shardings,
                                            param_specs)
    cfg = _cfg(arch)
    grid = _grid(grid_name)
    sh = param_shardings(grid, param_shapes(cfg), cfg)
    shapes = param_shapes(cfg)
    assert {n: s.spec for n, s in sh.items()} == fit_tree(
        param_specs(shapes, cfg), shapes, grid)
    got = init_params(cfg, _gen(), "cpu", sh)
    assert isinstance(got, ShardedLM) and got.grid == grid
    want = _cut(init_params(cfg, _gen(), "cpu"), sh)
    assert list(got.pieces) == list(want.pieces)
    split = 0
    for n, pieces in want.pieces.items():
        assert len(got.pieces[n]) == grid.size
        for a, b in zip(got.pieces[n], pieces):
            assert a.dtype == b.dtype and torch.equal(a, b), n
        split += sh[n].counts(pieces[0].dim()) != (1,) * pieces[0].dim()
        # holders of one block share one tensor
        blocks = sh[n].blocks(pieces[0].dim())
        for i, bi in enumerate(blocks):
            assert (got.pieces[n][i] is got.pieces[n][blocks.index(bi)])
    assert split > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_shard_train_state_equals_shard_state(arch):
    from repro_torch.train.train_step import (init_train_state, shard_state,
                                              state_shardings)
    from repro_torch.models.model import param_shapes
    cfg = _cfg(arch)
    sh = state_shardings(_grid(), {"params": param_shapes(cfg)}, cfg)
    got = init_train_state(cfg, _gen(), "cpu", shardings=sh)
    want = shard_state(init_train_state(cfg, _gen(), "cpu"), sh)
    assert torch.equal(got["opt"]["step"], want["opt"]["step"])
    for tree in ("params", "m", "v", "master"):
        g = got["params"] if tree == "params" else got["opt"][tree]
        w = want["params"] if tree == "params" else want["opt"][tree]
        assert list(g) == list(w)
        for n in w:
            for a, b in zip(g[n], w[n]):
                assert a.dtype == b.dtype and torch.equal(a, b), (tree, n)
            # one tensor a distinct piece, as shard_state shares them
            assert len({id(p) for p in g[n]}) == len({id(p) for p in w[n]})
    # master is a copy: updating it leaves the parameters as they are
    n = next(iter(got["params"]))
    assert got["opt"]["master"][n][0].data_ptr() != \
        got["params"][n][0].data_ptr()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharded_steps_from_a_per_shard_state_are_bit_for_bit(arch):
    from repro_torch.models.model import param_shapes
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (gather_state, init_train_state,
                                              jit_train_step, shard_state,
                                              state_shardings)
    cfg = _cfg(arch)
    grid = _grid()
    sh = state_shardings(grid, {"params": param_shapes(cfg)}, cfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (8, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    if cfg.encoder_layers:
        batch["enc_input"] = rng.standard_normal(
            (8, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        batch["positions"] = np.broadcast_to(
            np.arange(16, dtype=np.int32)[:, None], (8, 16, 3)).copy()
    step = jit_train_step(cfg, OptConfig(**OPT), grid)
    runs = []
    for state in (init_train_state(cfg, _gen(), "cpu", shardings=sh),
                  shard_state(init_train_state(cfg, _gen(), "cpu"), sh)):
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(m["loss"])
        runs.append((torch.stack(losses), gather_state(state, sh)))
    (l1, s1), (l2, s2) = runs
    assert torch.equal(l1, l2) and bool(l1[-1] < l1[0])
    for n, t in s2["params"].items():
        assert torch.equal(s1["params"][n], t), n


@pytest.fixture(scope="module")
def olmoe():
    """olmoe-1b-7b's smoke leaves as the reference's numpy tree (the
    port's init, layers stacked), its whole model and its shardings on
    (4, 2)."""
    from repro_torch.convert import _stacked
    from repro_torch.models.model import init_params
    from repro_torch.sharding.rules import param_shardings
    cfg = _cfg("olmoe-1b-7b")
    whole = init_params(cfg, _gen(), "cpu")
    leaves = _stacked({n: t.detach().numpy()
                       for n, t in whole.named_parameters()})
    return cfg, leaves, whole, param_shardings(_grid(), whole, cfg)


def _serve(params, cfg, ctx):
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serve.engine import generate
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (8, 16)))
    logits, cache = prefill(params, {"tokens": x}, cfg, 20, ctx)
    step, _ = decode_step(params, x[:, -1:], cache, cfg,
                          ctx=dataclasses.replace(ctx, seq_sharded=False))
    return logits, step, generate(params, cfg, x, 3, ctx=ctx)


def test_loaded_and_restored_shards_serve_as_is(olmoe, tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.sharding.rules import make_ctx
    cfg, leaves, whole, sh = olmoe
    ctx = make_ctx(_grid())
    loaded = lm_params_from_numpy(leaves, cfg, "cpu", sh)
    want = _cut(whole, sh)
    for n, pieces in want.pieces.items():
        for a, b in zip(loaded.pieces[n], pieces):
            assert torch.equal(a, b), n
            # read block by block: each piece's storage holds its block
            assert a.untyped_storage().nbytes() == a.numel() * 4
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(3, {n: t.detach() for n, t in whole.named_parameters()})
    restored = mgr.restore(3, {n: (tuple(t.shape), t.dtype) for n, t in
                               whole.named_parameters()}, "cpu", sh)
    assert isinstance(restored, dict)
    runs = [_serve(p, cfg, ctx) for p in (loaded, restored, whole)]
    for got in runs[1:]:
        for a, b in zip(got, runs[0]):
            assert torch.equal(a, b) if a.dtype == torch.int64 else \
                float((a - b).norm() / b.norm()) <= 1e-6
    assert torch.equal(runs[0][0], runs[1][0])


def test_a_grid_refuses_pieces_off_it_and_batches_it_cannot_split(olmoe):
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.sharded import ShardedLM
    from repro_torch.sharding.rules import make_ctx, param_shardings
    cfg, _, whole, sh = olmoe
    model = _cut(whole, sh)
    name = "layers.0.attn.wq"
    pieces = dict(model.pieces)
    pieces[name] = pieces[name][:-1] + [
        torch.empty(pieces[name][-1].shape, device="meta")]
    with pytest.raises(ValueError, match="grid's device"):
        ShardedLM(cfg, sh, pieces)
    with pytest.raises(ValueError, match="block"):
        ShardedLM(cfg, sh, {**model.pieces, name: [
            torch.zeros(3, 3)] * N_DEV})
    with pytest.raises(ValueError, match="names"):
        ShardedLM(cfg, sh, {k: v for k, v in model.pieces.items()
                            if k != name})
    ctx = make_ctx(_grid())
    x = torch.zeros((6, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="does not split"):
        prefill(model, {"tokens": x}, cfg, 12, ctx)
    _, whole_cache = prefill(whole, {"tokens": x[:4]}, cfg, 12, ctx)
    with pytest.raises(ValueError, match="rows"):
        decode_step(model, x[:4, :1], whole_cache, cfg, ctx=ctx)
    other = make_ctx(grid_of((torch.device("cpu"),) * N_DEV, (8, 1),
                             ("data", "model")))
    with pytest.raises(ValueError, match="grid"):
        prefill(model, {"tokens": x[:4]}, cfg, 12, other)
    with pytest.raises(ValueError, match="ctx"):
        prefill(dict(model.pieces), {"tokens": x[:4]}, cfg, 12)
    # a plan of a full-size model allocates nothing
    full = get_config("qwen2-vl-72b")
    from repro_torch.models.model import param_shapes
    plan = param_shardings(_grid(), param_shapes(full), full)
    assert plan["embed"].spec == ("model", "data")


def test_pipeline_config_json_round_trips_and_reads_the_reference():
    from repro.api.config import presets as j_presets
    from repro_torch.api.config import PipelineConfig, presets
    from repro_torch.convert import config_from_reference_dict
    for name in presets():
        p = presets(name)
        assert PipelineConfig.from_json(p.to_json()) == p
        assert PipelineConfig.from_json(p.to_json(indent=None)) == p
    for name in j_presets():
        ref = j_presets(name)
        got = PipelineConfig.from_json(ref.to_json())
        assert got == config_from_reference_dict(ref.to_dict())
        if name in presets():
            assert got == presets(name)
