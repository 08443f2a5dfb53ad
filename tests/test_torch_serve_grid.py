"""Serving on a device grid with the weights held as shards, and window
classification over a grid, on REPRO_TEST_DEVICES=8 logical CPU devices
against the reference's own grid code, in f32 at smoke size:

  * the reference's ``prefill`` and a ``decode_step`` jitted with
    ``in_shardings`` from ``param_specs`` fitted by ``fit_tree``, as its
    dry run lowers them (repro/launch/dryrun.py:78-113; the decode with
    ``seq_sharded=False``, the cache laid out by ``cache_specs_tree``):
    qwen3-14b and olmoe-1b-7b on (4, 2), (8, 1) and (2, 4), qwen3-14b on
    (1, 8), whisper-large-v3 (through ``encode(ctx)``) on (8, 1), (1, 8)
    and (2, 4) and qwen2-vl-72b (M-RoPE, a prompt with an image) on
    (8, 1) and (1, 8); mamba2-130m and hymba-1.5b (meta tokens, windows,
    the SSM state split by heads) on (1, 8) and (2, 4), and hymba with
    ``ssm_headdim=32`` (4 SSM heads, 276 ``in_proj`` columns) on (1, 8),
    where the fit keeps the state and ``in_proj`` whole and splits
    ``norm_scale`` and ``out_proj``, as full hymba's on (1, 4);
    and (``PROFILE_CASES``) qwen3-14b under the ``kv_heads`` profile on
    (2, 4) and (4, 2), and on (1, 8) with a max_len that does not divide
    by "model", so the fit keeps the cache's length whole, and hymba
    under ``perf``'s banded windows on (1, 8) and (2, 4) (its windowed
    layer's chunks through ``banded_core`` at their offsets). Against them
    the port's ``prefill`` and ``decode_step`` on a ``ShardedLM`` of the
    same grid, loaded per shard from the same numpy leaves
    (``lm_params_from_numpy(..., shardings=param_shardings(...))``):
    logits within 1e-5 relative L2 (whisper's encoder states too). Where
    "model" is larger than 1 the port serves in the reference's layout
    (models/model.py: the "model" path; context-parallel prefill and
    encoder, tensor-parallel decode and cross-attention, the cache in its
    fitted pieces), elsewhere a
    dp row a device (the "rows" path). The sharded run against the
    port's whole model under the same ``ctx``: 1e-6 (the model path's
    partial sums are reduced across devices), bit for bit on a (1, 1)
    grid's row path; ``generate(ctx=)``'s greedy tokens equal the whole
    model's;
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
         ("whisper-large-v3", (8, 1)), ("qwen2-vl-72b", (8, 1)),
         ("qwen3-14b", (2, 4)), ("qwen3-14b", (1, 8)),
         ("olmoe-1b-7b", (2, 4)), ("qwen2-vl-72b", (1, 8)),
         ("whisper-large-v3", (1, 8)), ("whisper-large-v3", (2, 4)),
         ("mamba2-130m", (1, 8)), ("mamba2-130m", (2, 4)),
         ("hymba-1.5b", (1, 8)), ("hymba-1.5b", (2, 4)),
         ("hymba-1.5b+hd32", (1, 8)))
# config variants: an arch id, "+", a tag of the fields it replaces
VARIANTS = {"hd32": {"ssm_headdim": 32}}
# S + NEW (the cache's max_len) divides by every "model" axis above, so
# each splits the cache by length
B, S, NEW = 8, 16, 8
# (arch, grid, profile, max_len): the cache by heads (qwen3's 2 KV heads
# over 4 model devices do not divide, so the fit keeps them whole; over
# 2 they split), a max_len that does not divide by 8, and hymba's
# windowed layer through banded_core's chunk form at each chunk's offset
# ("banded": ``_profile``)
PROFILE_CASES = (("qwen3-14b", (2, 4), "kv_heads", S + NEW),
                 ("qwen3-14b", (4, 2), "kv_heads", S + NEW),
                 ("qwen3-14b", (1, 8), "baseline", S + 4),
                 ("hymba-1.5b", (1, 8), "banded", S + NEW),
                 ("hymba-1.5b", (2, 4), "banded", S + NEW))
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


def _arch_cfg(get_config, arch: str, dtype):
    """The smoke config of ``arch`` ("name" or "name+variant") in
    ``dtype``."""
    name, _, tag = arch.partition("+")
    return dataclasses.replace(get_config(name, smoke=True), dtype=dtype,
                               **VARIANTS.get(tag, {}))


def _profile(profiles, name: str):
    """The profile ``name`` of ``profiles`` (either package's PROFILES);
    "banded": perf's banded windows with f32 scores (the reference
    rounds its bf16 scores as XLA issues them, not as the port does)."""
    if name == "banded":
        return dataclasses.replace(profiles["perf"], name="banded",
                                   bf16_scores=False)
    return profiles[name]


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

    from repro.sharding.rules import PROFILES
    params_of = {}
    for arch, shape, profile, max_len in (
            [(a, sh, "baseline", S + NEW) for a, sh in CASES]
            + list(PROFILE_CASES)):
        cfg = _arch_cfg(get_config, arch, jnp.float32)
        if arch not in params_of:
            params_of[arch] = init_params(cfg, jax.random.PRNGKey(0))
            res.update(_flat(jax.tree.map(np.asarray, params_of[arch]),
                             f"{arch}/leaves"))
        params = params_of[arch]
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(auto,) * 2)
        key = _key(arch, shape, profile, max_len)
        data = _batch(cfg.vocab, arch, cfg.d_model, cfg.encoder_ctx)
        batch = {k: jnp.asarray(data[k]) for k in
                 ("tokens", "positions", "enc_input") if k in data}
        p_sh = named(mesh, fit_tree(param_specs(params, cfg), params, mesh))
        b_sh = named(mesh, fit_tree(
            {k: v for k, v in batch_specs(cfg, mesh, "prefill").items()
             if k in batch}, batch, mesh))
        ctx = make_ctx(mesh, profile=_profile(PROFILES, profile))
        fn = jax.jit(functools.partial(prefill, cfg=cfg, max_len=max_len,
                                       ctx=ctx), in_shardings=(p_sh, b_sh))
        logits, cache = fn(params, batch)
        res[f"{key}/prefill"] = np.asarray(logits)
        c_sh = named(mesh, fit_tree(cache_specs_tree(
            cfg, mesh, _profile(PROFILES, profile)), cache, mesh))
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
            # the decode step takes the states at P(dp, None, None)
            enc = jax.device_put(enc, enc_sh)
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


def _key(arch, shape, profile="baseline", max_len=S + NEW) -> str:
    key = f"{arch}/{shape[0]}x{shape[1]}"
    if (profile, max_len) != ("baseline", S + NEW):
        key += f"/{profile}/{max_len}"
    return key


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cfg(arch):
    import torch
    from repro_torch.configs import get_config
    return _arch_cfg(get_config, arch, torch.float32)


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
    """Each case's port runs: {key: (sharded prefill logits, its cache
    (one a dp row, or pieces), sharded decode logits, whole prefill and
    decode logits, the encoder states sharded and whole, generate's
    tokens sharded and whole, the paths taken)}, from the reference's
    leaves."""
    import torch
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import model as m
    from repro_torch.serve.engine import generate
    from repro_torch.sharding.rules import (PROFILES, make_ctx,
                                            param_shardings)
    out = {}
    for arch, shape, profile, max_len in (
            [(a, sh, "baseline", S + NEW) for a, sh in CASES]
            + list(PROFILE_CASES)):
        cfg = _cfg(arch)
        leaves = _unflat(ref, f"{arch}/leaves")
        grid = _grid(shape)
        whole = lm_params_from_numpy(leaves, cfg, "cpu")
        sharded = lm_params_from_numpy(leaves, cfg, "cpu",
                                       param_shardings(grid, whole, cfg))
        ctx = make_ctx(grid, profile=_profile(PROFILES, profile))
        dctx = dataclasses.replace(ctx, seq_sharded=False)
        data = _batch(cfg.vocab, arch, cfg.d_model, cfg.encoder_ctx)
        batch = {k: torch.from_numpy(data[k]) for k in
                 ("tokens", "positions", "enc_input") if k in data}
        token = torch.from_numpy(data["token"]).long()
        r = {}
        for name, p in (("sharded", sharded), ("whole", whole)):
            m.reset_paths()
            logits, cache = m.prefill(p, batch, cfg, max_len, ctx)
            enc = None
            if cfg.encoder_layers:
                enc = m.encode(p, data["enc_input"], cfg, ctx)
            step, _ = m.decode_step(p, token, cache, cfg, enc=enc,
                                    ctx=dctx)
            paths = dict(m.path_counts)
            gen = None
            if not cfg.mrope and max_len == S + NEW:
                gen = generate(p, cfg, data["tokens"], NEW, ctx=ctx,
                               enc_input=data.get("enc_input"))
            r[name] = {"prefill": logits, "cache": cache, "decode": step,
                       "enc": enc, "generate": gen, "paths": paths}
        r["profile"], r["max_len"] = profile, max_len
        out[_key(arch, shape, profile, max_len)] = r
    return out


def _all_cases():
    return [(a, sh, "baseline", S + NEW) for a, sh in CASES] \
        + list(PROFILE_CASES)


@pytest.mark.parametrize("arch,shape", CASES)
def test_sharded_serving_matches_the_reference(arch, shape, ref, served):
    _matches_the_reference(_key(arch, shape), ref, served)


@pytest.mark.parametrize("arch,shape,profile,max_len", PROFILE_CASES)
def test_cache_layouts_serve_as_the_reference(arch, shape, profile, max_len,
                                              ref, served):
    """The kv_heads profile and a max_len the "model" axis does not
    divide: the reference's numbers, the whole model's within 1e-6, and
    the cache in the reference's fitted blocks."""
    key = _key(arch, shape, profile, max_len)
    _matches_the_reference(key, ref, served)
    _matches_the_whole_model(key, shape, served, arch)


def _matches_the_reference(key, ref, served):
    arch = key.split("/")[0]
    got = served[key]["sharded"]
    for what in ("prefill", "decode"):
        assert tuple(got[what].shape) == (B, 1, _cfg(arch).vocab)
        rel = _rel(got[what].numpy(), ref[f"{key}/{what}"])
        assert rel <= TOL, (what, rel)
    if got["enc"] is not None:
        assert _rel(got["enc"].numpy(), ref[f"{key}/enc"]) <= TOL


@pytest.mark.parametrize("arch,shape", CASES)
def test_sharded_serving_matches_the_whole_model(arch, shape, served):
    _matches_the_whole_model(_key(arch, shape), shape, served, arch)


def _matches_the_whole_model(key, shape, served, arch):
    """The sharded run against the whole model's under the same ctx, each
    on its path; the cache: one block a dp row on the row path, on the
    model path the pieces of the reference's fitted layout."""
    import torch
    r = served[key]
    got, want = r["sharded"], r["whole"]
    path = "model" if shape[1] > 1 else "rows"
    assert got["paths"] == {"whole": 0, "rows": 0, "model": 0, path: 2}
    assert want["paths"] == {"whole": 2, "rows": 0, "model": 0}
    exact = shape[0] == 1 and path == "rows"
    for what in ("prefill", "decode", "enc"):
        if got[what] is None:
            continue
        if exact:
            assert torch.equal(got[what], want[what]), what
        else:
            assert _rel(got[what].numpy(), want[what].numpy()) <= SELF_TOL
    if got["generate"] is not None:
        assert torch.equal(got["generate"], want["generate"])
    cache = got["cache"]
    assert cache["idx"] == S + _cfg(arch).meta_tokens
    names = [t for t in ("k", "v", "state", "conv") if t in want["cache"]]
    if path == "rows":
        # the cache is one block a dp row, each of the row's B / dp rows
        rows = cache["rows"]
        assert len(rows) == shape[0]
        pieces = {t: torch.cat([c[t] for c in rows], 1) for t in names}
    else:
        _cache_pieces_are_the_fitted_blocks(cache, shape, arch,
                                            r["profile"], r["max_len"])
        pieces = {t: cache["shardings"][t].gather(cache["pieces"][t])
                  for t in names}
    for t in names:
        whole = want["cache"][t]
        assert torch.equal(pieces[t], whole) if exact \
            else _rel(pieces[t].numpy(), whole.numpy()) <= SELF_TOL


def _cache_pieces_are_the_fitted_blocks(cache, shape, arch, profile,
                                        max_len, batch=B):
    """Each grid device's piece of each cache entry (k, v; state, conv) is
    its block of the profile's cache_specs_tree fitted by fit_spec to the
    whole entry's shape (the reference's fit_tree), on its device; -> the
    fitted specs."""
    from repro_torch.models.model import cache_shapes
    from repro_torch.sharding.rules import PROFILES, cache_specs_tree, \
        fit_spec
    specs = {}
    cfg = _cfg(arch)
    for t, (whole, _) in cache_shapes(cfg, batch, max_len).items():
        sh, pieces = cache["shardings"][t], cache["pieces"][t]
        specs[t] = fit_spec(cache_specs_tree(cfg, sh.grid,
                                             _profile(PROFILES, profile))[t],
                            whole, sh.grid)
        assert sh.spec == specs[t]
        assert len(pieces) == shape[0] * shape[1]
        for p, dev, blk in zip(pieces, sh.grid.flat, sh.slices(whole)):
            assert tuple(p.shape) == tuple(s.stop - s.start for s in blk)
            assert p.device == dev
    return specs


def test_dp_one_grid_serves_bit_for_bit_and_its_moe_groups_stay_split(ref):
    """llama4-scout (a shared expert on top) on (1, 4): one dp row, its 4
    experts over 4 model indices, served over "model"; the prefill and a
    decode step within 1e-6 of the whole model's under the same ctx (the
    tensor-parallel partial sums are reduced across the devices), the
    MoE's expert paths taken, and each layer's expert group g assembled
    from its own pieces alone (never a whole stack). On a (1, 1) grid, the
    row path: bit for bit."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models import model as m
    from repro_torch.models.sharded import EXPERT_LEAVES, ModelRow, \
        row_model, row_plans
    from repro_torch.sharding.rules import make_ctx, param_shardings
    cfg = _cfg("llama4-scout-17b-a16e")
    whole = m.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 16)))
    for shape, path in (((1, 4), "model"), ((1, 1), "rows")):
        grid = _grid(shape)
        sharded = _cut(whole, param_shardings(grid, whole, cfg))
        ctx = make_ctx(grid)
        assert m.serve_path(sharded, cfg, ctx) == path
        moe.reset_paths()
        got = m.prefill(sharded, {"tokens": x}, cfg, 20, ctx)
        assert moe.path_counts["a2a"] == cfg.n_layers
        want = m.prefill(whole, {"tokens": x}, cfg, 20, ctx)
        moe.reset_paths()
        step = m.decode_step(sharded, x[:, -1:], got[1], cfg, ctx=ctx)[0]
        assert moe.path_counts["replicated" if shape[1] > 1 else "a2a"] \
            == cfg.n_layers
        want_step = m.decode_step(whole, x[:, -1:], want[1], cfg,
                                  ctx=ctx)[0]
        if path == "rows":
            assert torch.equal(got[0], want[0])
            assert torch.equal(step, want_step)
        else:
            assert _rel(got[0].numpy(), want[0].numpy()) <= SELF_TOL
            assert _rel(step.numpy(), want_step.numpy()) <= SELF_TOL
    grid = _grid((1, 4))
    sharded = _cut(whole, param_shardings(grid, whole, cfg))
    ctx = make_ctx(grid)
    (plan,) = row_plans(ctx)
    # the model path's expert group g: device g's own pieces
    row = ModelRow(sharded, plan)
    E_l = cfg.n_experts // 4
    for g, w in enumerate(row.local("layers.0.moe.w_gate")):
        assert w is sharded.pieces["layers.0.moe.w_gate"][g]
        assert torch.equal(w, whole.layers[0].moe.w_gate[
            g * E_l:(g + 1) * E_l])
    lp = row_model(cfg, sharded.pieces, sharded.shardings, plan,
                   experts=True).layers[0].gather()
    assert not any(hasattr(lp.moe, p.split(".")[1]) for p in EXPERT_LEAVES)
    for g in range(4):
        w_gate = lp.moe.ep_groups[(g, torch.device("cpu"))][1]
        assert torch.equal(w_gate, whole.layers[0].moe.w_gate[
            g * E_l:(g + 1) * E_l])


def test_decode_over_model_gathers_no_layer_and_reads_its_own_pieces(
        monkeypatch):
    """qwen3-14b, whisper-large-v3, mamba2-130m, hymba-1.5b and hymba
    with ``ssm_headdim=32`` on (1, 8): a decode step gathers no layer
    (calls neither LayerShards.gather nor ModelRow.whole_layer) and reads
    every parameter through its device's own piece (the piece itself: no
    copy), writes the new key into the one piece that holds its position,
    steps the SSM state in every device's piece (its own heads, or all of
    them where the fit keeps the state whole), and each device's cache
    piece is its fitted cache_specs_tree block; the prefill gathers each
    layer once. With a max_len that does not divide by 8 the KV cache
    stays whole on each device, as the reference's fit keeps it.
    Whisper's states come from ``encode`` (each encoder layer gathered
    once), and the decode step reads the copies the prefill placed: none
    placed again."""
    import torch
    from repro_torch.models import model as m
    from repro_torch.models import sharded as shd
    from repro_torch.sharding.rules import make_ctx, param_shardings
    for arch, seed in (("qwen3-14b", 1), ("whisper-large-v3", 6),
                       ("mamba2-130m", 7), ("hymba-1.5b", 8),
                       ("hymba-1.5b+hd32", 9)):
        with monkeypatch.context() as mp:
            _decode_over_model_reads_its_own_pieces(
                mp, torch, m, shd, make_ctx, param_shardings, arch, seed)


def _decode_over_model_reads_its_own_pieces(monkeypatch, torch, m, shd,
                                            make_ctx, param_shardings, arch,
                                            seed):
    cfg = _cfg(arch)
    whole = m.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    grid = _grid((1, 8))
    sharded = _cut(whole, param_shardings(grid, whole, cfg))
    ctx = make_ctx(grid)
    calls, reads, placed = [0], [], [0]
    gather, local = shd.LayerShards.gather, shd.ModelRow.local
    whole_layer = shd.ModelRow.whole_layer
    place = m._placed_states

    def counting(self, *a, **kw):
        calls[0] += 1
        return gather(self, *a, **kw)

    def counting_whole(self, *a, **kw):
        calls[0] += 1
        return whole_layer(self, *a, **kw)

    def reading(self, name):
        out = local(self, name)
        reads.append(all(t is p for t, p in zip(out,
                                                 sharded.pieces[name])))
        return out
    def placing(*a):
        placed[0] += 1
        return place(*a)
    monkeypatch.setattr(shd.LayerShards, "gather", counting)
    monkeypatch.setattr(shd.ModelRow, "whole_layer", counting_whole)
    monkeypatch.setattr(shd.ModelRow, "local", reading)
    monkeypatch.setattr(m, "_placed_states", placing)
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 16)))
    enc = None
    if cfg.encoder_layers:
        enc = m.encode(sharded, np.random.default_rng(5).standard_normal(
            (2, cfg.encoder_ctx, cfg.d_model)).astype(np.float32), cfg, ctx)
        assert calls[0] == cfg.encoder_layers
        calls[0] = 0
    for max_len, split in ((24, True), (21, False)):
        logits, cache = m.prefill(sharded, {"tokens": x}, cfg, max_len, ctx,
                                  enc=enc)
        assert calls[0] == cfg.n_layers
        assert placed[0] == int(enc is not None)
        calls[0], reads[:], placed[0] = 0, [], 0
        before = {t: [p.clone() for p in cache["pieces"][t]]
                  for t in ("k", "state") if t in cache["pieces"]}
        step, cache = m.decode_step(sharded, x[:, -1:], cache, cfg, enc=enc,
                                    ctx=ctx)
        assert calls[0] == 0 and reads and all(reads) and placed[0] == 0
        specs = _cache_pieces_are_the_fitted_blocks(cache, (1, 8), arch,
                                                    "baseline", max_len, 2)
        M = cfg.meta_tokens
        if cfg.has_attention:
            assert specs["k"][2] == ("model" if split else None)
            owner = (16 + M) // ((max_len + M) // 8) if split else None
            for d, (a, b) in enumerate(zip(before["k"],
                                           cache["pieces"]["k"])):
                assert torch.equal(a, b) != (not split or d == owner)
        if cfg.has_ssm:
            heads = cfg.ssm_heads % 8 == 0
            assert specs["state"][2] == ("model" if heads else None)
            assert (all(a is b for a in cache["pieces"]["state"]
                        for b in cache["pieces"]["state"]) != heads)
            for a, b in zip(before["state"], cache["pieces"]["state"]):
                assert not torch.equal(a, b)
        want = m.decode_step(whole, x[:, -1:], m.prefill(
            whole, {"tokens": x}, cfg, max_len, enc=enc)[1], cfg,
            enc=enc)[0]
        assert _rel(step.numpy(), want.numpy()) <= SELF_TOL
        calls[0] = 0


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "internlm2-20b",
                                  "command-r-35b"])
def test_every_dense_config_serves_over_model_as_the_whole_model(arch):
    """The dense family's other configs (command-r ties its embeddings:
    the logits over the embedding's vocab rows) on (2, 4) over "model":
    the prefill, two decode steps and generate's tokens as the whole
    model's (1e-6 in f32), the path counter "model"."""
    import torch
    from repro_torch.models import model as m
    from repro_torch.serve.engine import generate
    from repro_torch.sharding.rules import make_ctx, param_shardings
    cfg = _cfg(arch)
    whole = m.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    grid = _grid((2, 4))
    sharded = _cut(whole, param_shardings(grid, whole, cfg))
    ctx = make_ctx(grid)
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (4, 16)))
    m.reset_paths()
    got = generate(sharded, cfg, x, 4, ctx=ctx)
    assert m.path_counts == {"whole": 0, "rows": 0, "model": 4}
    assert torch.equal(got, generate(whole, cfg, x, 4, ctx=ctx))
    (a, ca), (b, cb) = (m.prefill(p, {"tokens": x}, cfg, 24, ctx)
                        for p in (sharded, whole))
    for t in range(2):
        assert _rel(a.numpy(), b.numpy()) <= SELF_TOL, t
        a, ca = m.decode_step(sharded, x[:, t:t + 1], ca, cfg, ctx=ctx)
        b, cb = m.decode_step(whole, x[:, t:t + 1], cb, cfg, ctx=ctx)
    assert _rel(a.numpy(), b.numpy()) <= SELF_TOL


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
