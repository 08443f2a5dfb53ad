"""The sharded (ZeRO-3) train step over a grid's "model" axis, on
REPRO_TEST_DEVICES=8 logical CPU devices against the reference's own
``jit_train_step`` (its batch at ``batch_specs(..., "train")``: tokens,
labels and positions at P(dp, "model"), the sequence context-parallel),
in f32 at smoke size:

  * qwen3-14b (dense) on (1, 4), (2, 2) and (2, 4); olmoe-1b-7b (MoE, at
    capacity factor E / k, so no shard's capacity drops a token) on
    (1, 4) and (2, 2); qwen2-vl-72b with an image prompt (M-RoPE, the
    masked ``_sdpa`` branch of each chunk) on (1, 4); whisper-large-v3
    (the encoder context-parallel over its seeded frames, every key
    visible, then the decoder's chunks with their cross-attention over
    the gathered states) on (1, 4), (2, 2) and (2, 4); mamba2-130m (the
    SSD context-parallel, each chunk's state handed on in model-index
    order, the conv reading the rows before its chunk) and hymba-1.5b
    (meta tokens first; attention and SSM side by side; its window on
    each chunk's band) on (1, 4), (2, 2) and (2, 4) -- from the same
    numpy state (the reference's ``init_train_state``, loaded per shard
    with ``lm_params_from_numpy(..., shardings=)``): one step's loss and
    grad norm, and every updated parameter and AdamW moment, within 1e-5
    relative L2, on a batch whose ignored labels fall unevenly over the
    dp rows and the chunks; the step took the "model" path (the flash
    forward and backward at each chunk's offset where the prompt is
    index-causal, on hymba's global layer alone and none on mamba2;
    whisper's encoder chunks non-causal against all its frames), the MoE
    its all-to-all;
  * ``train_path`` says "model" for every family on the same grids and
    "rows" on a (4, 1) grid.

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
CASES = (("qwen3-14b", (1, 4)), ("qwen3-14b", (2, 2)), ("qwen3-14b", (2, 4)),
         ("olmoe-1b-7b", (1, 4)), ("olmoe-1b-7b", (2, 2)),
         ("qwen2-vl-72b", (1, 4)), ("whisper-large-v3", (1, 4)),
         ("whisper-large-v3", (2, 2)), ("whisper-large-v3", (2, 4)),
         ("mamba2-130m", (1, 4)), ("mamba2-130m", (2, 2)),
         ("mamba2-130m", (2, 4)), ("hymba-1.5b", (1, 4)),
         ("hymba-1.5b", (2, 2)), ("hymba-1.5b", (2, 4)))
ARCHS = ("qwen3-14b", "olmoe-1b-7b", "qwen2-vl-72b", "whisper-large-v3",
         "mamba2-130m", "hymba-1.5b")
GRIDS = ((1, 4), (2, 2), (2, 4))
B, S = 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TOL = 1e-5


def _config(get_config, arch, f32):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=f32)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def _batch(vocab: int, arch: str) -> dict:
    """Seeded tokens and labels, the ignored labels packed into row 0's
    first chunks and a stretch of row 3; qwen2-vl's (B, S, 3) positions of
    5 text tokens, a 4 x 4 patch image (one t, so not index-causal) and
    11 text tokens; whisper's seeded frame embeddings (B, 32, 64), its
    smoke encoder_ctx and d_model."""
    toks = np.random.default_rng(6).integers(0, vocab, (B, S + 1))
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "labels": toks[:, 1:].astype(np.int32)}
    out["labels"][0, :20] = -100
    out["labels"][3, 9:14] = -100
    if arch == "qwen2-vl-72b":
        txt = np.repeat(np.arange(5)[:, None], 3, 1)
        r, c = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
        img = np.stack([np.zeros(16, int), r.ravel(), c.ravel()], 1) + 5
        after = np.repeat((np.arange(11) + img.max() + 1)[:, None], 3, 1)
        pos = np.concatenate([txt, img, after]).astype(np.int32)
        out["positions"] = np.broadcast_to(pos, (B, S, 3)).copy()
    if arch == "whisper-large-v3":
        out["enc_input"] = np.random.default_rng(7).standard_normal(
            (B, 32, 64)).astype(np.float32)
    return out


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


def _key(arch, shape) -> str:
    return f"{arch}/{shape[0]}x{shape[1]}"


# =====================================================================
# the reference's side (run as a script with 8 JAX host devices)
# =====================================================================

def _reference(out: str) -> None:
    from repro import platform  # noqa: F401  (REPRO_TEST_DEVICES first)
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.train import optimizer as j_opt
    from repro.train import train_step as j_ts
    assert len(jax.devices()) == N_DEV, jax.devices()
    auto = jax.sharding.AxisType.Auto
    opt = j_opt.OptConfig(**OPT)
    res, init = {}, {}

    def shape_of(tree):
        return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            tree)

    for arch, shape in CASES:
        cfg = _config(get_config, arch, jnp.float32)
        if arch not in init:
            init[arch] = j_ts.init_train_state(cfg, jax.random.PRNGKey(0))
            res.update(_flat(jax.tree.map(np.asarray, init[arch]),
                             f"{arch}/init"))
        n = shape[0] * shape[1]
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(auto,) * 2,
                             devices=jax.devices()[:n])
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab,
                                                      arch).items()}
        state = init[arch]
        step = j_ts.jit_train_step(cfg, opt, mesh, shape_of(state),
                                   shape_of(batch), donate=False)
        state = jax.device_put(state, j_ts.state_shardings(
            mesh, shape_of(state), cfg))
        state, met = step(state, batch)
        key = _key(arch, shape)
        for k in ("loss", "grad_norm"):
            res[f"{key}/{k}"] = np.asarray(met[k])
        res.update(_flat(jax.tree.map(np.asarray, state), f"{key}/state"))
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
    d = tmp_path_factory.mktemp("train_grid")
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
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.abs(got).max(initial=0.0))


def _cfg(arch):
    import torch
    from repro_torch.configs import get_config
    return _config(get_config, arch, torch.float32)


def _grid(shape):
    """A grid of logical CPU devices (the module fixtures build theirs
    before the REPRO_TEST_DEVICES fixture runs)."""
    import torch
    from repro_torch.launch.mesh import grid_of
    return grid_of((torch.device("cpu"),) * (shape[0] * shape[1]), shape,
                   ("data", "model"))


def _sharded_state(leaves, cfg, grid):
    """The sharded step's state from the reference's numpy parameters:
    each leaf's blocks read straight onto their devices
    (``lm_params_from_numpy(..., shardings=)``), the optimizer's f32
    master a copy of each piece, m and v zeros, as ``init_train_state(...,
    shardings=)`` lays them out."""
    import torch
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.model import param_shapes
    from repro_torch.train import train_step as ts
    sh = ts.state_shardings(grid, {"params": param_shapes(cfg)}, cfg)
    model = lm_params_from_numpy(leaves, cfg, "cpu", sh["params"])
    opt = {"step": torch.zeros((), dtype=torch.int32)}
    for k in ("m", "v", "master"):
        opt[k] = {n: ts._per_piece(p, k) for n, p in model.pieces.items()}
    return {"params": model.pieces, "opt": opt}, sh


@pytest.fixture(scope="module")
def trained(ref):
    """Each case's port step: {key: (metrics, the state gathered whole,
    the paths, flash launches by direction)}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn
    from repro_torch.models import model as m
    from repro_torch.models import moe
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts
    out = {}
    for arch, shape in CASES:
        cfg = _cfg(arch)
        grid = _grid(shape)
        state, sh = _sharded_state(_unflat(ref, f"{arch}/init")["params"],
                                   cfg, grid)
        step = ts.jit_train_step(cfg, opt_mod.OptConfig(**OPT), grid)
        batch = {k: torch.from_numpy(v) for k, v in
                 _batch(cfg.vocab, arch).items()}
        m.reset_paths()
        moe.reset_paths()
        seen = {"fwd": [], "bwd": []}
        real = (fa.flash_attention, fa.flash_attention_bwd)

        def fwd(q, k, v, causal=True, lse=False, q_offset=0):
            seen["fwd"].append((q.shape[2], k.shape[2], q_offset, causal))
            return real[0](q, k, v, causal, lse, q_offset)

        def bwd(q, k, v, out, dout, lse, causal=True, q_offset=0):
            seen["bwd"].append((q.shape[2], k.shape[2], q_offset, causal))
            return real[1](q, k, v, out, dout, lse, causal, q_offset)

        # the recompute's forward calls the kernel through FlashAttention,
        # the first (no grad) pass straight from models/attention.py
        fa.flash_attention, fa.flash_attention_bwd = fwd, bwd
        attn.flash_attention = fwd
        try:
            state, met = step(state, batch)
        finally:
            fa.flash_attention, fa.flash_attention_bwd = real
            attn.flash_attention = real[0]
        out[_key(arch, shape)] = (
            {k: float(v) for k, v in met.items()},
            ts.gather_state(state, sh), dict(m.path_counts),
            dict(moe.path_counts), seen)
    return out


@pytest.mark.parametrize("arch,shape", CASES, ids=[_key(*c) for c in CASES])
def test_model_axis_step_matches_the_reference(arch, shape, ref, trained):
    from repro_torch.convert import _stacked
    key = _key(arch, shape)
    met, got, paths, moe_paths, seen = trained[key]
    assert paths["model"] == 1 and paths["rows"] == 0, paths
    for k in ("loss", "grad_norm"):
        want = float(ref[f"{key}/{k}"])
        assert abs(met[k] - want) <= TOL * abs(want), (k, met[k], want)
    want = _unflat(ref, f"{key}/state")
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    worst = {}
    for part, tree, wtree in [("params", got["params"], want["params"])] + [
            (k, got["opt"][k], want["opt"][k]) for k in ("m", "v", "master")]:
        g = _stacked({n: t.detach().numpy() for n, t in tree.items()})
        for path, w in _flat(wtree, part).items():
            node = g
            for name in path.split("/")[1:]:
                node = node[name]
            worst[path] = _rel(node, w)
    bad = {p: e for p, e in worst.items() if e > TOL}
    assert not bad, bad
    tp = shape[1]
    chunk = S // tp
    layers = _cfg(arch).n_layers
    if arch == "mamba2-130m":
        assert seen["fwd"] == seen["bwd"] == []
    elif arch == "hymba-1.5b":
        # the global layer's chunks of the meta tokens and the prompt at
        # their offsets; the windowed layer reads its band through _sdpa
        cfg = _cfg(arch)
        Sm = cfg.meta_tokens + S
        chunks = [(Sm // tp, Sm, g * Sm // tp, True) for g in range(tp)] \
            * len(cfg.global_attn_layers)
        rows = shape[0]
        assert sorted(seen["fwd"]) == sorted(chunks * (2 * rows))
        assert sorted(seen["bwd"]) == sorted(chunks * rows)
    elif arch == "qwen2-vl-72b":
        # the image's patches share one t: every chunk takes _sdpa
        assert seen["fwd"] == seen["bwd"] == []
    elif arch == "whisper-large-v3":
        # the encoder's chunks of its T frames against all T, every key
        # visible, and the decoder's at their offsets, each forward twice
        # (with the recompute) and backward once
        cfg = _cfg(arch)
        T = cfg.encoder_ctx
        enc = [(T // tp, T, 0, False)] * (tp * cfg.encoder_layers)
        chunks = [(chunk, S, g * chunk, True) for g in range(tp)] * layers
        rows = shape[0]
        assert sorted(seen["fwd"]) == sorted((enc + chunks) * (2 * rows))
        assert sorted(seen["bwd"]) == sorted((enc + chunks) * rows)
    else:
        # each chunk at its offset, forward (and its recompute) and
        # backward, against the row's whole sequence
        chunks = [(chunk, S, g * chunk, True) for g in range(tp)]
        rows = shape[0]
        assert seen["fwd"] == chunks * (2 * layers * rows)
        assert sorted(seen["bwd"]) == sorted(chunks * (layers * rows))
    if arch == "olmoe-1b-7b":
        assert moe_paths["a2a"] > 0 and moe_paths["local"] == 0, moe_paths


@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_path_by_family(shape):
    import torch
    from repro_torch.models import model as m
    from repro_torch.models.model import init_params, param_shapes
    from repro_torch.sharding.rules import make_ctx, param_shardings
    grid = _grid(shape)
    ctx = make_ctx(grid)
    one = _grid((4, 1))
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            param_shardings(grid, param_shapes(cfg), cfg))
        m.reset_paths()
        assert m.train_path(model.pieces, cfg, ctx) == "model", arch
        assert m.path_counts == {"whole": 0, "rows": 0, "model": 1}
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            param_shardings(one, param_shapes(cfg), cfg))
        assert m.train_path(model, cfg, make_ctx(one)) == "rows", arch


def test_gathered_copies_sum_their_gradients_in_model_index_order():
    """A leaf split over "model" on (1, 4), gathered whole onto each model
    index (``gather_copies``, as ``ModelRow.whole_layer`` and ``whole``
    read a layer and the head under grad): one copy an index, each the
    whole leaf; the backward gives each piece the sum of the copies'
    gradients at its block in f32 in model-index order, rounded once --
    with gradients 1, 2^27, 1 and -2^27 every element is that order's f32
    sum, 0, where the reverse order gives 1 and the exact sum is 2; in
    f32 and bf16. Without a gradient the copies are one a distinct
    device."""
    import torch
    from repro_torch.models.sharded import gather_copies, row_plans
    from repro_torch.sharding.rules import Sharding, make_ctx
    grid = _grid((1, 4))
    (plan,) = row_plans(make_ctx(grid))
    sh = Sharding(grid, (None, "model"))
    for dtype in (torch.float32, torch.bfloat16):
        whole = torch.randn(3, 8).to(dtype)
        pieces = [p.detach().requires_grad_() for p in sh.shard(whole)]
        copies = gather_copies(sh, pieces, plan.group_devices,
                               plan.group_orders)
        assert len(copies) == 4 and len({id(c) for c in copies}) == 4
        assert all(torch.equal(c, whole) for c in copies)
        vals = (1.0, 2.0 ** 27, 1.0, -2.0 ** 27)
        grads = [torch.full((3, 8), v, dtype=dtype) for v in vals]

        def f32_sum(vs):
            acc = torch.zeros((), dtype=torch.float32)
            for v in vs:
                acc = acc + v
            return float(acc)
        want = f32_sum(vals)
        assert want == 0.0 and f32_sum(vals[::-1]) == 1.0
        torch.autograd.backward(copies, grads)
        for p in pieces:
            assert p.grad.dtype == dtype
            assert torch.equal(p.grad, torch.full_like(p.grad, want))
        with torch.no_grad():
            frozen = gather_copies(sh, pieces, plan.group_devices,
                                   plan.group_orders)
        assert all(c is frozen[0] for c in frozen)
        assert torch.equal(frozen[0], whole)


if __name__ == "__main__":
    _reference(sys.argv[1])
