"""The port's LM mesh paths on REPRO_TEST_DEVICES=8 logical CPU devices
against the reference's own mesh code, in f32 at smoke size:

  * the expert-parallel MoE (models/moe.py): ``moe_ffn`` through
    ``_moe_ep_a2a`` (B 8 x S 64) and ``_moe_ep_replicated`` (B 8 x S 1)
    on a (4, 2) grid for olmoe-1b-7b and llama4-scout (its shared expert
    on top), within 1e-5 relative L2: at the smoke configs' capacity
    factor (nothing drops) and at capacity_factor 1.0, where each shard's
    own capacity drops tokens; and ``moe_ffn``'s choice of path over a
    table of (B, S, grid, seq_sharded) equal to the reference's;
  * ``jit_train_step`` (ZeRO-3) on (4, 2) for qwen3-14b and olmoe-1b-7b,
    and for qwen3-14b over 2 microbatches:
    3 steps' loss, grad_norm and lr within test_torch_lm_train.py's f32
    limit (1e-5 relative), then every leaf of params, m, v and master
    within 2e-5 (a batch twice that file's; v squares the gradient), on a
    batch whose -100 labels fall unevenly over the dp rows;
  * ``make_ddp_train_step`` on a ("pod", "data") = (2, 4) grid, plain and
    int8-compressed: 3 steps' loss (1e-5), grad_norm and the parameters
    (1e-5 plain; 1e-4 compressed, where a value on an int8 rounding
    boundary may round the other way);
  * ``gpipe_apply`` forward (L 8, M 6) and backward (L 4, M 4) on a
    4-stage "pipe" grid (tests/test_pipeline.py's cases), within 1e-5,
    and ``bubble_fraction``;
  * elastic checkpoints: tests/test_distributed.py:129's tree saved from
    a (4, 2) grid and restored onto (2, 4) and (8, 1), each package
    loading the other's.

The reference's mesh code needs 8 JAX host devices, which must be set
before JAX starts, so it runs once per module in a subprocess -- this
file run as a script (the ``__main__`` block) -- that writes an .npz.
The port's side and the reference's take the same numpy inputs and the
reference's seeded weights.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_DEV = 8
MOE_ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e")
# (arch, microbatches) of the sharded trainer
TRAIN_CASES = (("qwen3-14b", 1), ("olmoe-1b-7b", 1), ("qwen3-14b", 2))
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TOL = 1e-5
# the compressed DDP step's parameters: a gradient value within an f32
# ulp of an int8 rounding boundary may take the other code in one package
# than in the other (measured: 1.05e-5 at q_norm after 3 steps)
COMPRESSED_TOL = 1e-4
# the sharded step's state after 3 steps: B 8 (twice test_torch_lm_train's
# batch) and v the square of the gradient; measured worst 1.07e-5 (v of
# layers.attn.wq), every other leaf <= 9.1e-6 -- the f32 noise of the
# port's flash attention against the reference's einsum _sdpa
STATE_TOL = 2e-5
# moe_ffn's dispatch table: (arch, B, S, grid shape, axes, seq_sharded)
GRIDS = {"4x2": ((4, 2), ("data", "model")),
         "8x1": ((8, 1), ("data", "model")),
         "1x8": ((1, 8), ("data", "model")),
         "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
DISPATCH = [(arch, B, S, g, seq)
            for arch in MOE_ARCHS for g in sorted(GRIDS)
            for B, S in ((8, 64), (6, 16), (2, 1), (8, 3))
            for seq in (True, False)]


def _moe_x(d_model: int, S: int) -> np.ndarray:
    return np.random.default_rng(S).standard_normal(
        (8, S, d_model)).astype(np.float32)


def _train_batch(vocab: int, B: int = 8, S: int = 32) -> dict:
    """Tokens and labels with the ignored labels packed into the first
    dp row (rows 0-1 of a (4, 2) grid's B 8): the mean of the rows' means
    is not the global mean."""
    toks = np.random.default_rng(4).integers(0, vocab, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    batch["labels"][0, :29] = -100
    batch["labels"][1, 4:] = -100
    batch["labels"][5, :3] = -100
    return batch


def _pipe_params(L: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((L, d, d)) * d ** -0.5
                  ).astype(np.float32),
            "b": (rng.standard_normal((L, d)) * 0.1).astype(np.float32)}


def _pipe_x(M: int, B: int, d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (M, B, d)).astype(np.float32)


PIPE_FWD = dict(L=8, d=16, M=6, B=2)
PIPE_BWD = dict(L=4, d=8, M=4, B=2)
CKPT_W = np.arange(64, dtype=np.float32).reshape(8, 8)


def _flat(tree, prefix):
    """A nested dict of arrays as {"prefix/a/b": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _unflat(res, prefix):
    """The inverse of ``_flat`` for the keys of ``res`` under prefix."""
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

def _reference(out: str, port_ckpt: str, ref_ckpt: str) -> None:
    from repro import platform  # noqa: F401  (REPRO_TEST_DEVICES first)
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.checkpoint.manager import CheckpointManager
    from repro.configs import get_config
    from repro.models import moe as j_moe
    from repro.models.model import init_params
    from repro.train import optimizer as j_opt
    from repro.train import pipeline as j_pipe
    from repro.train import train_step as j_ts
    assert len(jax.devices()) == N_DEV, jax.devices()
    res = {}
    # Auto axes: the GSPMD trainer leaves layouts to the compiler, which
    # this JAX's default Explicit axes refuse (its embedding gather)
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(auto,) * 2)

    for arch in MOE_ARCHS:
        base = dataclasses.replace(get_config(arch, smoke=True),
                                   dtype=jnp.float32)
        lp = jax.tree.map(lambda x: x[0], init_params(
            base, jax.random.PRNGKey(0))["layers"]["moe"])
        res.update(_flat(lp, f"moe/{arch}/leaves"))
        ctx = j_moe.ShardingCtx(mesh=mesh, dp_axes=("data",),
                                tp_axis="model", seq_sharded=True)

        def run(lp, xs, base=base, ctx=ctx):
            return {f"{cf}/{S}": j_moe.moe_ffn(
                x, lp, dataclasses.replace(base, capacity_factor=cf), ctx)
                for cf in (base.capacity_factor, 1.0)
                for S, x in xs.items()}
        xs = {S: jnp.asarray(_moe_x(base.d_model, S)) for S in (64, 1)}
        res.update(_flat(jax.tree.map(np.asarray, jax.jit(run)(lp, xs)),
                         f"moe/{arch}"))

    # the dispatch table: which of the three paths moe_ffn calls
    took = []
    stubs = {name: (lambda name: lambda x, *a, **k: (
        took.append(name), jnp.zeros_like(x))[1])(name)
        for name in ("_moe_local", "_moe_ep_a2a", "_moe_ep_replicated")}
    saved = {name: getattr(j_moe, name) for name in stubs}
    for name, fn in stubs.items():
        setattr(j_moe, name, fn)
    try:
        for arch, B, S, g, seq in DISPATCH:
            cfg = get_config(arch, smoke=True)
            shape, axes = GRIDS[g]
            m = jax.make_mesh(shape, axes)
            ctx = j_moe.ShardingCtx(
                mesh=m, dp_axes=tuple(a for a in axes if a != "model"),
                tp_axis="model", seq_sharded=seq)
            p = {"router": None, "shared": None}
            cfg = dataclasses.replace(cfg, shared_expert=False)
            j_moe.moe_ffn(jnp.zeros((B, S, 4)), p, cfg, ctx)
    finally:
        for name, fn in saved.items():
            setattr(j_moe, name, fn)
    res["dispatch"] = np.asarray(took)

    opt = j_opt.OptConfig(**OPT)
    for arch, mb in TRAIN_CASES:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=jnp.float32)
        state = j_ts.init_train_state(cfg, jax.random.PRNGKey(0))
        res.update(_flat(jax.tree.map(np.asarray, state),
                         f"train/{arch}/init"))
        batch = {k: jnp.asarray(v) for k, v in
                 _train_batch(cfg.vocab).items()}
        shape_of = functools.partial(jax.tree.map, lambda x:
                                     jax.ShapeDtypeStruct(x.shape, x.dtype))
        step = j_ts.jit_train_step(cfg, opt, mesh, shape_of(state),
                                   shape_of(batch), microbatches=mb,
                                   donate=False)
        state = jax.device_put(state, j_ts.state_shardings(
            mesh, shape_of(state), cfg))
        for i in range(3):
            state, met = step(state, batch)
            for k in ("loss", "grad_norm", "lr"):
                res[f"train/{arch}/{mb}/{i}/{k}"] = np.asarray(met[k])
        res.update(_flat(jax.tree.map(np.asarray, state),
                         f"train/{arch}/{mb}/state"))

    pod = jax.make_mesh((2, 4), ("pod", "data"))
    cfg = dataclasses.replace(get_config("qwen3-14b", smoke=True),
                              dtype=jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in
             _train_batch(cfg.vocab, S=16).items()}
    for compress in (False, True):
        state = j_ts.init_ddp_state(cfg, jax.random.PRNGKey(0))
        step = jax.jit(j_ts.make_ddp_train_step(cfg, opt, pod,
                                                compress=compress))
        with jax.set_mesh(pod):
            for i in range(3):
                state, met = step(state, batch)
                for k in ("loss", "grad_norm"):
                    res[f"ddp/{compress}/{i}/{k}"] = np.asarray(met[k])
        res.update(_flat(jax.tree.map(np.asarray, state["params"]),
                         f"ddp/{compress}/params"))

    pipe = jax.make_mesh((4,), ("pipe",), axis_types=(auto,))

    def layer_fn(lp, x):
        return jnp.tanh(x @ lp["w"] + lp["b"])

    def pipe_run(fwd, fwd_x, bwd, bwd_x):
        return {"fwd": j_pipe.gpipe_apply(layer_fn, fwd, fwd_x, pipe),
                "bwd": jax.grad(lambda p: jnp.sum(j_pipe.gpipe_apply(
                    layer_fn, p, bwd_x, pipe) ** 2))(bwd)}
    f, b = PIPE_FWD, PIPE_BWD
    ran = jax.jit(pipe_run)(_pipe_params(f["L"], f["d"], 0),
                            _pipe_x(f["M"], f["B"], f["d"], 1),
                            _pipe_params(b["L"], b["d"], 2),
                            _pipe_x(b["M"], b["B"], b["d"], 3))
    res.update(_flat(jax.tree.map(np.asarray, ran), "pipe"))

    # checkpoints: save from (4, 2); restore the port's onto (2, 4), (8, 1)
    mgr = CheckpointManager(ref_ckpt, keep=2)
    tree = jax.device_put({"w": jnp.asarray(CKPT_W), "step": jnp.int32(7)},
                          {"w": NamedSharding(mesh, P("data", "model")),
                           "step": NamedSharding(mesh, P())})
    mgr.save(100, tree)
    target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          tree)
    port = CheckpointManager(port_ckpt, keep=2)
    for shape in ((2, 4), (8, 1)):
        m = jax.make_mesh(shape, ("data", "model"))
        got = port.restore(200, target, {
            "w": NamedSharding(m, P("data", "model")),
            "step": NamedSharding(m, P())})
        res[f"ckpt/{shape}/w"] = np.asarray(got["w"])
        res[f"ckpt/{shape}/step"] = np.asarray(got["step"])
        res[f"ckpt/{shape}/shard"] = np.asarray(
            got["w"].addressable_shards[0].data.shape)
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
    """The reference's results (the script below, 8 JAX host devices);
    the port's checkpoint is written first, for it to restore."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import grid_of
    from repro_torch.sharding.rules import Sharding
    d = tmp_path_factory.mktemp("mesh")
    grid = grid_of((torch.device("cpu"),) * 8, (4, 2), ("data", "model"))
    sh = Sharding(grid, ("data", "model"))
    pieces = sh.shard(torch.from_numpy(CKPT_W.copy()))
    CheckpointManager(str(d / "port"), keep=2).save(200, {
        "w": sh.gather(pieces), "step": torch.tensor(7, dtype=torch.int32)})
    env = dict(os.environ, REPRO_TEST_DEVICES=str(N_DEV), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = d / "ref.npz"
    run = subprocess.run([sys.executable, __file__, str(out),
                          str(d / "port"), str(d / "ref")], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(out) as z:
        yield {k: z[k] for k in z.files}, d


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.abs(got).max(initial=0.0))


def _cfg(arch, **kw):
    import torch
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32, **kw)


def _tensors(tree):
    """A nested dict of numpy arrays as a namespace of f32 tensors."""
    import types
    import torch
    return types.SimpleNamespace(**{
        k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
        for k, v in tree.items()})


def _grid(shape, axes):
    from repro_torch.launch.mesh import grid_of, visible_devices
    return grid_of(visible_devices("cpu"), shape, axes)


@pytest.mark.parametrize("cf", ["smoke", 1.0])
@pytest.mark.parametrize("S", [64, 1])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ep_paths_match_the_reference(arch, S, cf, ref):
    import torch
    from repro_torch.models import moe
    from repro_torch.sharding.rules import make_ctx
    res, _ = ref
    cfg = _cfg(arch)
    if cf != "smoke":
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    lp = _tensors(_unflat(res, f"moe/{arch}/leaves"))
    ctx = make_ctx(_grid((4, 2), ("data", "model")))
    x = torch.from_numpy(_moe_x(cfg.d_model, S))
    moe.reset_paths()
    with torch.inference_mode():
        got = moe.moe_ffn(x, lp, cfg, ctx)
        local = moe._moe_local(x, lp, cfg)
    path = "a2a" if S > 1 else "replicated"
    assert moe.path_counts == {"local": 0, "a2a": int(S > 1),
                               "replicated": int(S == 1)}
    want = res[f"moe/{arch}/{cfg.capacity_factor}/{S}"]
    assert _rel(got.numpy(), want) <= TOL, (path, _rel(got.numpy(), want))
    # the expert groups were laid out once, kept on the layer (one device,
    # 2 groups: views of the leaves) and read again by the next call
    key, groups = lp.ep_layout
    assert sorted(g for g, _ in groups) == [0, 1]
    E_l = cfg.n_experts // 2
    assert groups[(1, x.device)][1].data_ptr() == \
        lp.w_gate[E_l:].data_ptr()
    with torch.inference_mode():
        assert torch.equal(moe.moe_ffn(x, lp, cfg, ctx), got)
    assert lp.ep_layout[1] is groups
    # a leaf replaced, or changed in place, is laid out again: no stale
    # expert weights
    lp.w_down = lp.w_down.clone()
    with torch.inference_mode():
        assert torch.equal(moe.moe_ffn(x, lp, cfg, ctx), got)
    assert lp.ep_layout[1] is not groups
    groups = lp.ep_layout[1]
    with torch.no_grad():
        lp.w_down.mul_(2.0)
    with torch.inference_mode():
        changed = moe.moe_ffn(x, lp, cfg, ctx)
    assert lp.ep_layout[1] is not groups and not torch.equal(changed, got)
    if cf == 1.0 and path == "a2a":
        # per-shard capacity drops other tokens than the global one
        if cfg.shared_expert:
            local = local + moe.swiglu(x, lp.shared)
        assert _rel(local.numpy(), want) > 100 * TOL


def test_moe_dispatch_matches_the_reference(ref):
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.sharding.rules import make_ctx
    res, _ = ref
    got = []
    for arch, B, S, g, seq in DISPATCH:
        ctx = make_ctx(_grid(*GRIDS[g]), seq_sharded=seq)
        got.append("_moe_" + {"local": "local", "a2a": "ep_a2a",
                              "replicated": "ep_replicated"}[
            moe.moe_path(B, S, get_config(arch, smoke=True), ctx)])
    assert got == list(res["dispatch"])
    assert set(got) == {"_moe_local", "_moe_ep_a2a", "_moe_ep_replicated"}


def _ref_state(res, arch):
    """The reference's init_train_state (key 0) at smoke size in f32."""
    return _unflat(res, f"train/{arch}/init")


@pytest.mark.parametrize("arch,mb", TRAIN_CASES)
def test_sharded_train_step_matches_the_reference(arch, mb, ref):
    from repro_torch.convert import _stacked, train_state_from_numpy
    from repro_torch.models import moe
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts
    res, _ = ref
    cfg = _cfg(arch)
    grid = _grid((4, 2), ("data", "model"))
    state = train_state_from_numpy(_ref_state(res, arch), cfg, "cpu")
    sh = ts.state_shardings(grid, state, cfg)
    sharded = ts.shard_state(state, sh)
    step = ts.jit_train_step(cfg, opt_mod.OptConfig(**OPT), grid,
                             microbatches=mb)
    batch = _train_batch(cfg.vocab)
    moe.reset_paths()
    for i in range(3):
        sharded, m = step(sharded, batch)
        for k in ("loss", "grad_norm", "lr"):
            want = float(res[f"train/{arch}/{mb}/{i}/{k}"])
            assert abs(float(m[k]) - want) <= TOL * abs(want), (i, k)
    if cfg.is_moe:
        assert moe.path_counts["a2a"] > 0 and moe.path_counts["local"] == 0
    got = ts.gather_state(sharded, sh)
    want = _unflat(res, f"train/{arch}/{mb}/state")
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 3
    for key, tree, wtree in [("params", got["params"], want["params"])] + [
            (k, got["opt"][k], want["opt"][k]) for k in ("m", "v", "master")]:
        g = _stacked({n: t.detach().numpy() for n, t in tree.items()})
        for path, w in _flat(wtree, key).items():
            node = g
            for part in path.split("/")[1:]:
                node = node[part]
            assert _rel(node, w) <= STATE_TOL, (path, _rel(node, w))


def test_sharded_loss_is_the_global_mean_not_the_rows_mean(ref):
    """The unevenly masked batch: the mean of the dp rows' means differs
    from the global mean the reference takes (held to 1e-5 above) by over
    100 times that tolerance (1.2e-3 relative at this random init, where
    every position's nll is near log(vocab))."""
    import torch
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.model import nll_sum
    cfg = _cfg("qwen3-14b")
    params = lm_params_from_numpy(_ref_state(ref[0], "qwen3-14b")["params"],
                                  cfg, "cpu")
    batch = _train_batch(cfg.vocab)
    with torch.no_grad():
        parts = [nll_sum(params, {k: v[2 * r:2 * r + 2]
                                  for k, v in batch.items()}, cfg)
                 for r in range(4)]
    glob = sum(float(n) for n, _ in parts) / sum(int(c) for _, c in parts)
    rows = np.mean([float(n) / max(int(c), 1) for n, c in parts])
    assert abs(glob - float(ref[0]["train/qwen3-14b/1/0/loss"])) <= \
        TOL * glob
    assert abs(rows - glob) > 100 * TOL * glob


@pytest.mark.parametrize("compress", [False, True])
def test_ddp_over_pod_and_data_matches_the_reference(compress, ref):
    from repro_torch.convert import _stacked, train_state_from_numpy
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts
    res, _ = ref
    cfg = _cfg("qwen3-14b")
    # the reference's init_ddp_state: its init_train_state, zero residuals
    init = _ref_state(res, "qwen3-14b")
    init["residual"] = {k: v for k, v in _flat(init["params"], "r").items()}
    init["residual"] = _unflat({k: np.zeros_like(v) for k, v in
                                init["residual"].items()}, "r")
    state = train_state_from_numpy(init, cfg, "cpu", shards=8)
    grid = _grid((2, 4), ("pod", "data"))
    step = ts.make_ddp_train_step(cfg, opt_mod.OptConfig(**OPT), grid,
                                  compress=compress)
    batch = _train_batch(cfg.vocab, S=16)
    for i in range(3):
        state, m = step(state, batch)
        for k in ("loss", "grad_norm"):
            want = float(res[f"ddp/{compress}/{i}/{k}"])
            tol = COMPRESSED_TOL if compress and k == "grad_norm" else TOL
            assert abs(float(m[k]) - want) <= tol * abs(want), (i, k)
    assert len(state["residual"]) == 8
    got = _stacked({n: p.detach().numpy()
                    for n, p in state["params"].named_parameters()})
    for path, w in _flat(_unflat(res, f"ddp/{compress}/params"),
                         "p").items():
        node = got
        for part in path.split("/")[1:]:
            node = node[part]
        assert _rel(node, w) <= (COMPRESSED_TOL if compress else TOL), \
            (path, _rel(node, w))


def _pipe_fn(lp, x):
    import torch
    return torch.tanh(x @ lp["w"] + lp["b"])


def _pipe_layers(params):
    import torch
    L = len(params["w"])
    return [{k: torch.from_numpy(v[i].copy()).requires_grad_()
             for k, v in params.items()} for i in range(L)]


def test_gpipe_forward_and_backward_match_the_reference(ref):
    import torch
    from repro_torch.train.pipeline import bubble_fraction, gpipe_apply
    res, _ = ref
    grid = _grid((4,), ("pipe",))
    c = PIPE_FWD
    layers = _pipe_layers(_pipe_params(c["L"], c["d"], 0))
    x = torch.from_numpy(_pipe_x(c["M"], c["B"], c["d"], 1))
    out = gpipe_apply(_pipe_fn, layers, x, grid, axis="pipe")
    np.testing.assert_allclose(out.detach().numpy(), res["pipe/fwd"],
                               rtol=TOL, atol=TOL)
    seq = x
    for lp in layers:
        seq = _pipe_fn(lp, seq)
    np.testing.assert_allclose(out.detach().numpy(), seq.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    c = PIPE_BWD
    layers = _pipe_layers(_pipe_params(c["L"], c["d"], 2))
    x = torch.from_numpy(_pipe_x(c["M"], c["B"], c["d"], 3))
    (gpipe_apply(_pipe_fn, layers, x, grid) ** 2).sum().backward()
    for k in ("w", "b"):
        got = np.stack([lp[k].grad.numpy() for lp in layers])
        np.testing.assert_allclose(got, res[f"pipe/bwd/{k}"], rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(AssertionError):
        gpipe_apply(_pipe_fn, layers[:3], x, grid)
    assert bubble_fraction(1, 4) == pytest.approx(0.75)
    assert bubble_fraction(32, 4) == pytest.approx(3 / 35)
    assert bubble_fraction(8, 1) == 0.0


@pytest.mark.parametrize("shape", [(2, 4), (8, 1)])
def test_checkpoints_restore_elastically_across_packages(shape, ref):
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.sharding.rules import Sharding
    res, d = ref
    # the port's checkpoint (saved from (4, 2)) as the reference read it
    np.testing.assert_array_equal(res[f"ckpt/{shape}/w"], CKPT_W)
    assert int(res[f"ckpt/{shape}/step"]) == 7
    # the reference's, restored by the port onto the same grid
    grid = _grid(shape, ("data", "model"))
    shardings = {"w": Sharding(grid, ("data", "model")),
                 "step": Sharding(grid, ())}
    got = CheckpointManager(str(d / "ref"), keep=2).restore(
        100, {"w": ((8, 8), torch.float32), "step": ((), torch.int32)},
        "cpu", shardings)
    assert len(got["w"]) == 8
    assert tuple(got["w"][0].shape) == tuple(res[f"ckpt/{shape}/shard"])
    # each piece read on its own: its storage holds its block, not the leaf
    assert all(p.untyped_storage().nbytes() == p.numel() * 4
               for p in got["w"])
    np.testing.assert_array_equal(shardings["w"].gather(got["w"]).numpy(),
                                  CKPT_W)
    assert all(int(s) == 7 for s in got["step"])


if __name__ == "__main__":
    _reference(*sys.argv[1:4])
