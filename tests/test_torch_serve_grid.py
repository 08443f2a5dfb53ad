"""Serving on a device grid with the weights held as shards, and window
classification over a grid, on REPRO_TEST_DEVICES=8 logical CPU devices
against the reference's own grid code, in f32 at smoke size:

  * the reference's ``prefill`` and a ``decode_step`` jitted with
    ``in_shardings`` from ``param_specs`` fitted by ``fit_tree``, as its
    dry run lowers them (repro/launch/dryrun.py:78-113; the decode with
    ``seq_sharded=False``): qwen3-14b and olmoe-1b-7b on (4, 2) and
    (8, 1), whisper-large-v3 (through ``encode(ctx)``) and qwen2-vl-72b
    (M-RoPE, a prompt with an image) on (8, 1). Against them the port's
    ``prefill`` and ``decode_step`` on a ``ShardedLM`` of the same grid,
    loaded per shard from the same numpy leaves
    (``lm_params_from_numpy(..., shardings=param_shardings(...))``):
    logits within 1e-5 relative L2 (whisper's encoder states too). The
    sharded run against the port's whole model under the same ``ctx``:
    1e-6, bit for bit where dp is 1; ``generate(ctx=)``'s greedy tokens
    equal the whole model's;
  * ``shard_over_data`` and ``jax.jit(classify_windows,
    *detection_step_specs(mesh))`` on a (4, 2) mesh, 64 windows, path
    ``ref``, against the port's over 8 logical devices: scores within
    test_torch_window.py's paper tolerance (1e-4); the port's grid run
    equals its one-device run bit for bit on every path.

The reference's grid code needs 8 JAX host devices, set before JAX
starts, so it runs once per module in a subprocess -- this file run as a
script (the ``__main__`` block) -- that writes an .npz (as
tests/test_torch_lm_mesh.py does).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_DEV = 8
CASES = (("qwen3-14b", (4, 2)), ("qwen3-14b", (8, 1)),
         ("olmoe-1b-7b", (4, 2)), ("olmoe-1b-7b", (8, 1)),
         ("whisper-large-v3", (8, 1)), ("qwen2-vl-72b", (8, 1)))
B, S, NEW = 8, 16, 4
TOL = 1e-5                     # the port against the reference
SELF_TOL = 1e-6                # sharded against whole, where dp > 1
WIN_B, WIN_GRID = 64, (4, 2)
WIN_TOL = 1e-4                 # test_torch_window.py's SCORE_TOL["paper"]
GOLDEN = ROOT / "tests" / "golden" / "hog_golden.npz"


def _batch(cfg_vocab: int, arch: str, d_model: int, enc_ctx: int) -> dict:
    """The prompt: seeded tokens; qwen2-vl's (B, S, 3) positions of 4 text
    tokens, a 3 x 3 patch image and 3 text tokens; whisper's seeded frame
    embeddings; and the decode step's token."""
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg_vocab, (B, S)).astype(np.int32),
           "token": rng.integers(0, cfg_vocab, (B, 1)).astype(np.int32)}
    if arch == "qwen2-vl-72b":
        txt = np.repeat(np.arange(4)[:, None], 3, 1)
        r, c = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
        img = np.stack([np.zeros(9, int), r.ravel(), c.ravel()], 1) + 4
        after = np.repeat((np.arange(3) + img.max() + 1)[:, None], 3, 1)
        pos = np.concatenate([txt, img, after]).astype(np.int32)
        out["positions"] = np.broadcast_to(pos, (B, S, 3)).copy()
    if arch == "whisper-large-v3":
        out["enc_input"] = rng.standard_normal(
            (B, enc_ctx, d_model)).astype(np.float32)
    return out


def _windows() -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, 256, (WIN_B, 130, 66, 3)).astype(np.uint8)


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _unflat(res, prefix):
    tree = {}
    for key, value in res.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *dirs, leaf = key[len(prefix) + 1:].split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = value
    return tree


# =====================================================================
# the reference's side (run as a script with 8 JAX host devices)
# =====================================================================

def _reference(out: str) -> None:
    from repro import platform  # noqa: F401  (REPRO_TEST_DEVICES first)
    import functools
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.core import pipeline as j_pipe
    from repro.models.model import decode_step, encode, init_params, prefill
    from repro.sharding.rules import (batch_specs, cache_specs_tree,
                                      dp_axes, fit_tree, make_ctx,
                                      param_specs)
    assert len(jax.devices()) == N_DEV, jax.devices()
    auto = jax.sharding.AxisType.Auto
    res = {}

    def named(mesh, specs):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))

    params_of = {}
    for arch, shape in CASES:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=jnp.float32)
        if arch not in params_of:
            params_of[arch] = init_params(cfg, jax.random.PRNGKey(0))
            res.update(_flat(jax.tree.map(np.asarray, params_of[arch]),
                             f"{arch}/leaves"))
        params = params_of[arch]
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(auto,) * 2)
        key = f"{arch}/{shape[0]}x{shape[1]}"
        data = _batch(cfg.vocab, arch, cfg.d_model, cfg.encoder_ctx)
        batch = {k: jnp.asarray(data[k]) for k in
                 ("tokens", "positions", "enc_input") if k in data}
        p_sh = named(mesh, fit_tree(param_specs(params, cfg), params, mesh))
        b_sh = named(mesh, fit_tree(
            {k: v for k, v in batch_specs(cfg, mesh, "prefill").items()
             if k in batch}, batch, mesh))
        ctx = make_ctx(mesh)
        fn = jax.jit(functools.partial(prefill, cfg=cfg, max_len=S + NEW,
                                       ctx=ctx), in_shardings=(p_sh, b_sh))
        logits, cache = fn(params, batch)
        res[f"{key}/prefill"] = np.asarray(logits)
        c_sh = named(mesh, fit_tree(cache_specs_tree(cfg, mesh), cache,
                                    mesh))
        cache = jax.device_put(cache, c_sh)
        dctx = dataclasses.replace(ctx, seq_sharded=False)
        tok_sh = NamedSharding(mesh, P(dp_axes(mesh), None))
        token = jnp.asarray(data["token"])
        if cfg.encoder_layers:
            enc_sh = NamedSharding(mesh, P(dp_axes(mesh), None, None))
            enc = jax.jit(functools.partial(encode, cfg=cfg, ctx=ctx),
                          in_shardings=(p_sh, enc_sh))(
                params, batch["enc_input"])
            res[f"{key}/enc"] = np.asarray(enc)
            step = jax.jit(lambda p, t, c, e: decode_step(
                p, t, c, cfg, dctx, enc=e),
                in_shardings=(p_sh, tok_sh, c_sh, enc_sh))
            logits, _ = step(params, token, cache, enc)
        else:
            step = jax.jit(lambda p, t, c: decode_step(p, t, c, cfg, dctx),
                           in_shardings=(p_sh, tok_sh, c_sh))
            logits, _ = step(params, token, cache)
        res[f"{key}/decode"] = np.asarray(logits)

    # windows: the co-processor op over a (4, 2) mesh
    golden = np.load(GOLDEN)
    svm = {"w": jnp.asarray(golden["svm_w"], jnp.float32),
           "b": jnp.asarray(golden["svm_b"], jnp.float32)}
    mesh = jax.make_mesh(WIN_GRID, ("data", "model"), axis_types=(auto,) * 2)
    (w_sh, x_sh), out_sh = j_pipe.detection_step_specs(mesh)
    fn = jax.jit(functools.partial(j_pipe.classify_windows, path="ref"),
                 in_shardings=(w_sh, x_sh), out_shardings=out_sh)
    placed = j_pipe.shard_over_data(mesh, jnp.asarray(_windows()))
    res["windows/chunk"] = np.asarray(
        placed.addressable_shards[0].data.shape)
    got = fn(svm, placed)
    res["windows/score"] = np.asarray(got["score"])
    res["windows/human"] = np.asarray(got["human"])
    np.savez(out, **res)


# =====================================================================
# the port's side
# =====================================================================

@pytest.fixture(scope="module")
def port():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def devices(monkeypatch, port):
    monkeypatch.setenv("REPRO_TEST_DEVICES", str(N_DEV))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_grid")
    env = dict(os.environ, REPRO_TEST_DEVICES=str(N_DEV), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = d / "ref.npz"
    run = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(out) as z:
        yield {k: z[k] for k in z.files}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cfg(arch):
    import torch
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32)


def _cut(whole, shardings):
    """A whole model cut into its pieces (views of its leaves here)."""
    from repro_torch.models.sharded import ShardedLM, shard_leaf
    return ShardedLM(whole.cfg, shardings, {
        n: shard_leaf(shardings[n], t)
        for n, t in whole.named_parameters()})


def _grid(shape):
    """A grid of 8 logical CPU devices (the module fixtures build theirs
    before the REPRO_TEST_DEVICES fixture runs)."""
    import torch
    from repro_torch.launch.mesh import grid_of
    return grid_of((torch.device("cpu"),) * N_DEV, shape, ("data", "model"))


@pytest.fixture(scope="module")
def served(ref):
    """Each case's port runs: {key: (sharded prefill logits, its cache's
    rows, sharded decode logits, whole prefill and decode logits, the
    encoder states sharded and whole, generate's tokens sharded and
    whole)}, from the reference's leaves."""
    import torch
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.model import decode_step, encode, prefill
    from repro_torch.serve.engine import generate
    from repro_torch.sharding.rules import make_ctx, param_shardings
    out = {}
    for arch, shape in CASES:
        cfg = _cfg(arch)
        leaves = _unflat(ref, f"{arch}/leaves")
        grid = _grid(shape)
        whole = lm_params_from_numpy(leaves, cfg, "cpu")
        sharded = lm_params_from_numpy(leaves, cfg, "cpu",
                                       param_shardings(grid, whole, cfg))
        ctx = make_ctx(grid)
        dctx = dataclasses.replace(ctx, seq_sharded=False)
        data = _batch(cfg.vocab, arch, cfg.d_model, cfg.encoder_ctx)
        batch = {k: torch.from_numpy(data[k]) for k in
                 ("tokens", "positions", "enc_input") if k in data}
        token = torch.from_numpy(data["token"]).long()
        r = {}
        for name, p in (("sharded", sharded), ("whole", whole)):
            logits, cache = prefill(p, batch, cfg, S + NEW, ctx)
            enc = None
            if cfg.encoder_layers:
                enc = encode(p, data["enc_input"], cfg, ctx)
            step, _ = decode_step(p, token, cache, cfg, enc=enc, ctx=dctx)
            gen = None
            if not cfg.mrope:
                gen = generate(p, cfg, data["tokens"], NEW, ctx=ctx,
                               enc_input=data.get("enc_input"))
            r[name] = {"prefill": logits, "cache": cache, "decode": step,
                       "enc": enc, "generate": gen}
        out[f"{arch}/{shape[0]}x{shape[1]}"] = r
    return out


@pytest.mark.parametrize("arch,shape", CASES)
def test_sharded_serving_matches_the_reference(arch, shape, ref, served):
    key = f"{arch}/{shape[0]}x{shape[1]}"
    got = served[key]["sharded"]
    for what in ("prefill", "decode"):
        assert tuple(got[what].shape) == (B, 1, _cfg(arch).vocab)
        rel = _rel(got[what].numpy(), ref[f"{key}/{what}"])
        assert rel <= TOL, (what, rel)
    if got["enc"] is not None:
        assert _rel(got["enc"].numpy(), ref[f"{key}/enc"]) <= TOL


@pytest.mark.parametrize("arch,shape", CASES)
def test_sharded_serving_matches_the_whole_model(arch, shape, served):
    import torch
    r = served[f"{arch}/{shape[0]}x{shape[1]}"]
    got, want = r["sharded"], r["whole"]
    exact = shape[0] == 1
    for what in ("prefill", "decode", "enc"):
        if got[what] is None:
            continue
        if exact:
            assert torch.equal(got[what], want[what]), what
        else:
            assert _rel(got[what].numpy(), want[what].numpy()) <= SELF_TOL
    if got["generate"] is not None:
        assert torch.equal(got["generate"], want["generate"])
    # the cache is one block a dp row, each of the row's B / dp rows
    rows = got["cache"]["rows"]
    assert len(rows) == shape[0] and got["cache"]["idx"] == S
    for t in ("k", "v"):
        whole = want["cache"][t]
        assert torch.equal(torch.cat([c[t] for c in rows], 1), whole) \
            if exact else _rel(torch.cat([c[t] for c in rows], 1).numpy(),
                               whole.numpy()) <= SELF_TOL


def test_dp_one_grid_serves_bit_for_bit_and_its_moe_groups_stay_split(ref):
    """llama4-scout (a shared expert on top) on (1, 4): one dp row, its 4
    experts over 4 model indices; the prefill and a decode step equal the
    whole model's under the same ctx bit for bit, and each layer's expert
    group g is assembled from its own pieces alone (never a whole
    stack)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.models.sharded import EXPERT_LEAVES, row_model, \
        row_plans
    from repro_torch.sharding.rules import make_ctx, param_shardings
    cfg = _cfg("llama4-scout-17b-a16e")
    whole = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    grid = _grid((1, 4))
    sharded = _cut(whole, param_shardings(grid, whole, cfg))
    ctx = make_ctx(grid)
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 16)))
    got = prefill(sharded, {"tokens": x}, cfg, 20, ctx)
    want = prefill(whole, {"tokens": x}, cfg, 20, ctx)
    assert torch.equal(got[0], want[0])
    moe.reset_paths()
    step = decode_step(sharded, x[:, -1:], got[1], cfg, ctx=ctx)[0]
    assert moe.path_counts["replicated"] == cfg.n_layers
    assert torch.equal(step,
                       decode_step(whole, x[:, -1:], want[1], cfg,
                                   ctx=ctx)[0])
    (plan,) = row_plans(ctx)
    lp = row_model(cfg, sharded.pieces, sharded.shardings, plan,
                   experts=True).layers[0].gather()
    assert not any(hasattr(lp.moe, p.split(".")[1]) for p in EXPERT_LEAVES)
    E_l = cfg.n_experts // 4
    for g in range(4):
        w_gate = lp.moe.ep_groups[(g, torch.device("cpu"))][1]
        assert torch.equal(w_gate, whole.layers[0].moe.w_gate[
            g * E_l:(g + 1) * E_l])


def test_windows_over_a_grid_match_the_reference(ref):
    import torch
    from repro_torch.core.pipeline import (PlacedWindows, classify_windows,
                                           detection_step_specs,
                                           shard_over_data)
    golden = np.load(GOLDEN)
    svm = {"w": golden["svm_w"].astype(np.float32),
           "b": np.float32(golden["svm_b"])}
    grid = _grid(WIN_GRID)
    wins = _windows()
    placed = shard_over_data(grid, wins)
    assert isinstance(placed, PlacedWindows)
    assert tuple(placed.pieces[0].shape) == tuple(ref["windows/chunk"])
    # one chunk a device, the same chunk on both model indices of a row
    assert placed.pieces[0] is placed.pieces[1]
    assert placed.pieces[0] is not placed.pieces[2]
    (w_sh, x_sh), out_sh = detection_step_specs(grid)
    assert x_sh.spec == placed.sharding.spec == ("data", None, None, None)
    assert w_sh["w"].spec == (None,) and out_sh["score"].spec == ("data",)
    for path in ("ref", "kernel", "fused"):
        got = classify_windows(svm, placed, path=path)
        one = classify_windows(svm, wins, path=path, device="cpu")
        assert torch.equal(got["score"], one["score"]), path
        assert torch.equal(got["human"], one["human"]), path
        if path == "ref":
            np.testing.assert_allclose(got["score"].numpy(),
                                       ref["windows/score"], rtol=0,
                                       atol=WIN_TOL)
            np.testing.assert_array_equal(got["human"].numpy(),
                                          ref["windows/human"])
    # a tensor batch is placed from its own device, to the same result
    tplaced = shard_over_data(grid, torch.from_numpy(wins))
    assert torch.equal(classify_windows(svm, tplaced)["score"],
                       classify_windows(svm, placed)["score"])


def test_windows_on_other_devices_are_refused():
    import torch
    from repro_torch.core.pipeline import (PlacedWindows, classify_windows,
                                           shard_over_data)
    grid = _grid(WIN_GRID)
    placed = shard_over_data(grid, _windows())
    moved = PlacedWindows(placed.sharding, placed.pieces[:-1] + (
        torch.empty(placed.pieces[-1].shape, dtype=torch.uint8,
                    device="meta"),))
    with pytest.raises(ValueError, match="grid's device"):
        classify_windows({"w": np.zeros(3780, np.float32),
                          "b": np.float32(0)}, moved)
    with pytest.raises(ValueError):
        shard_over_data(grid, _windows()[:63])


if __name__ == "__main__":
    _reference(sys.argv[1])
