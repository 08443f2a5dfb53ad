"""The port's LM training (repro_torch.models.model.loss_fn,
repro_torch.train, repro_torch.data.lm_data, repro_torch.launch.train and
the train state in repro_torch.convert) against the JAX reference on the
CPU, for qwen3-14b at smoke size, on the same numpy batches and the
reference's own seeded weights and optimizer state carried over with
convert.train_state_from_numpy.

Tolerances, in f32: the loss within 1e-5 relative and every gradient
leaf within 1e-4 relative L2 of jax.value_and_grad(loss_fn) (the port's
attention takes the flash function, the reference's the einsum _sdpa:
summation order). Three train steps at the launcher's learning rate
(1e-3) within 1e-5: loss, grad_norm and lr relative, and every leaf of
params, master, m and v relative L2; with microbatches=2 too. One bf16
step is held against the reference compiled with XLA's excess precision
off (each bf16 op rounded as issued, as the port computes,
test_torch_lm_families_archs.py): the loss within 1e-3 relative, the
grad norm within 1e-2, every updated parameter leaf within 1e-2 relative
L2 and every m leaf within 5e-2 (measured on this CPU: 4.7e-6, 9.1e-4,
1.6e-3 and 1.4e-2; bf16 roundings of other intermediates, the flash
function's f32 scores against _sdpa's bf16 ones; ROADMAP queue 3).
"""
import dataclasses
import functools
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import lm_data as j_lm_data
from repro.models import model as j_model
from repro.train import grad_compress as j_gc
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch.convert import (model_config_from_reference_dict,
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data import lm_data
from repro_torch.models import model as t_model
from repro_torch.train import grad_compress as gc
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-14b"
B, S = 4, 32
LOSS_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)

torch.set_num_threads(1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.abs(got).max(initial=0.0))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _tree_close(got, want, tol, what):
    got, want = dict(_leaves(got)), dict(_leaves(jax.tree.map(
        lambda x: np.asarray(x, np.float32), want)))
    assert sorted(got) == sorted(want), what
    for k in want:
        assert np.shape(got[k]) == np.shape(want[k]), (what, k)
        assert _rel(got[k], want[k]) <= tol, (what, k, _rel(got[k], want[k]))


def _jcfg(dtype=jnp.float32, arch=ARCH):
    return dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype)


def _tcfg(jcfg):
    return model_config_from_reference_dict(dataclasses.asdict(jcfg))


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    batch["labels"][0, :5] = -100          # ignored positions
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_state(dtype=jnp.float32):
    """The reference's init_train_state at smoke size (key 0)."""
    jcfg = _jcfg(dtype)
    return jax.jit(j_ts.init_train_state, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def grads_pair():
    jcfg = _jcfg()
    batch = _batch(jcfg.vocab)
    jstate = _ref_state()
    loss_j, g_j = jax.jit(jax.value_and_grad(j_model.loss_fn),
                          static_argnums=2)(jstate["params"],
                                            _jbatch(batch), jcfg)
    state = train_state_from_numpy(_numpy(jstate), _tcfg(jcfg), "cpu")
    loss_t = t_model.loss_fn(state["params"], batch, _tcfg(jcfg))
    loss_t.backward()
    grads = {n: p.grad.numpy() for n, p in
             state["params"].named_parameters()}
    return float(loss_j), _numpy(g_j), float(loss_t.detach()), grads


def test_loss_matches_reference(grads_pair):
    loss_j, _, loss_t, _ = grads_pair
    assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j)


def test_every_gradient_leaf_matches_reference(grads_pair):
    from repro_torch.convert import _stacked
    _, g_j, _, grads = grads_pair
    _tree_close(_stacked(grads), g_j, GRAD_TOL, "grads")


def test_ignored_labels_do_not_count():
    """Labels of -100 drop out of the sum and the count; all ignored
    divides by 1 (a zero loss), as the reference."""
    jcfg = _jcfg()
    cfg = _tcfg(jcfg)
    state = train_state_from_numpy(_numpy(_ref_state()), cfg, "cpu")
    batch = _batch(cfg.vocab, seed=3)
    none = dict(batch, labels=np.full_like(batch["labels"], -100))
    with torch.no_grad():
        assert float(t_model.loss_fn(state["params"], none, cfg)) == 0.0
        got = float(t_model.loss_fn(state["params"], batch, cfg))
    want = float(jax.jit(j_model.loss_fn, static_argnums=2)(
        _ref_state()["params"], _jbatch(batch), jcfg))
    assert abs(got - want) <= LOSS_TOL * abs(want)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_reference(microbatches):
    jcfg = _jcfg()
    cfg = _tcfg(jcfg)
    batch = _batch(cfg.vocab, seed=1)
    jstep = jax.jit(j_ts.make_train_step(jcfg, j_opt.OptConfig(**OPT),
                                         microbatches=microbatches))
    step = ts.make_train_step(cfg, opt_mod.OptConfig(**OPT),
                              microbatches=microbatches)
    jstate = _ref_state()
    state = train_state_from_numpy(_numpy(jstate), cfg, "cpu")
    for i in range(3):
        jstate, jm = jstep(jstate, _jbatch(batch))
        state, m = step(state, batch)
        for key in ("loss", "grad_norm", "lr"):
            assert abs(float(m[key]) - float(jm[key])) <= \
                STEP_TOL * abs(float(jm[key])), (i, key)
    got = train_state_to_numpy(state, cfg)
    assert int(got["opt"]["step"]) == int(jstate["opt"]["step"]) == 3
    for key in ("m", "v", "master"):
        _tree_close(got["opt"][key], jstate["opt"][key], STEP_TOL, key)
    _tree_close(got["params"], jstate["params"], STEP_TOL, "params")


def test_bf16_step_matches_reference_without_excess_precision():
    jcfg = _jcfg(jnp.bfloat16)
    cfg = _tcfg(jcfg)
    batch = _batch(cfg.vocab, seed=2)
    jstate = _ref_state(jnp.bfloat16)
    state = train_state_from_numpy(_numpy(jstate), cfg, "cpu")
    fn = jax.jit(j_ts.make_train_step(jcfg, j_opt.OptConfig(**OPT)))
    compiled = fn.lower(jstate, _jbatch(batch)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    jnext, jm = compiled(jstate, _jbatch(batch))
    state, m = ts.make_train_step(cfg, opt_mod.OptConfig(**OPT))(state, batch)
    assert state["params"].embed.dtype == torch.bfloat16
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        1e-3 * float(jm["loss"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-2 * float(jm["grad_norm"])
    got = train_state_to_numpy(state, cfg)
    _tree_close(got["params"], jnext["params"], 1e-2, "bf16 params")
    _tree_close(got["opt"]["m"], jnext["opt"]["m"], 5e-2, "bf16 m")


# ------------------------------------------------------------- optimizer

def test_adamw_minimizes_quadratic():
    w = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(0.5)}
    state = opt_mod.init_opt_state(w)
    c = opt_mod.OptConfig(lr=0.1, warmup_steps=1, total_steps=200,
                          weight_decay=0.0, clip_norm=1e9)
    for _ in range(200):
        g = {"w": 2 * state["master"]["w"], "b": 2 * state["master"]["b"]}
        master, state, _ = opt_mod.adamw_update(g, state, c)
    loss = float((master["w"] ** 2).sum() + master["b"] ** 2)
    assert loss < 1e-2


def test_warmup_cosine_schedule_matches_reference():
    c = opt_mod.OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                          min_lr_frac=0.1)
    jc = j_opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                         min_lr_frac=0.1)
    assert float(opt_mod.schedule(0, c)) == pytest.approx(0.1, abs=1e-6)
    assert float(opt_mod.schedule(9, c)) == pytest.approx(1.0, abs=1e-6)
    assert float(opt_mod.schedule(109, c)) == pytest.approx(0.1, rel=1e-2)
    for s in (0, 5, 9, 10, 37, 60, 109, 200):
        got = opt_mod.schedule(torch.tensor(s, dtype=torch.int32), c)
        assert got.dtype == torch.float32
        assert float(got) == float(j_opt.schedule(jnp.int32(s), jc)), s


def test_clip_caps_update_norm():
    state = opt_mod.init_opt_state({"w": torch.zeros(4)})
    c = opt_mod.OptConfig(lr=1.0, clip_norm=1.0, warmup_steps=1,
                          weight_decay=0.0)
    _, state2, metrics = opt_mod.adamw_update(
        {"w": torch.full((4,), 1e6)}, state, c)
    assert float(metrics["grad_norm"]) > 1e5
    assert float(state2["m"]["w"].abs().max()) < 1.0


@pytest.mark.parametrize("scale", [1e-3, 0.37, 1.0, 55.0, 1e3])
def test_global_norm_homogeneous(scale):
    t = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor([[2.0]])}
    n1 = float(opt_mod.global_norm(t.values()))
    n2 = float(opt_mod.global_norm(x * scale for x in t.values()))
    assert n2 == pytest.approx(n1 * scale, rel=1e-4)
    assert n1 == pytest.approx(3.0)


def test_adamw_update_matches_reference_with_stacked_decay():
    """The reference decays leaves of ndim >= 2, its layer leaves stacked
    on a layer axis: every port leaf under layers. is decayed, a
    top-level vector is not."""
    rng = np.random.default_rng(5)
    shapes = {"embed": (6, 4), "final_norm": (4,), "ln": (3, 4),
              "w": (3, 4, 5), "A": (3, 2)}
    jw = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jg = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    names = {"embed": "embed", "final_norm": "final_norm.scale"}

    def port_names(k, tree):
        if k in names:
            return {names[k]: torch.from_numpy(tree[k].copy())}
        return {f"layers.{i}.{k}": torch.from_numpy(tree[k][i].copy())
                for i in range(3)}

    w = {n: t for k in shapes for n, t in port_names(k, jw).items()}
    g = {n: t for k in shapes for n, t in port_names(k, jg).items()}
    c = opt_mod.OptConfig(lr=0.05, warmup_steps=1, weight_decay=0.3)
    jc = j_opt.OptConfig(lr=0.05, warmup_steps=1, weight_decay=0.3)
    state = opt_mod.init_opt_state(w)
    jstate = j_opt.init_opt_state(jw)
    for _ in range(2):
        master, state, met = opt_mod.adamw_update(g, state, c)
        jmaster, jstate, jmet = j_opt.adamw_update(jg, jstate, jc)
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                    rel=1e-6)
    for k in shapes:
        got = port_names(k, {k: np.asarray(jmaster[k])})
        for n, want in got.items():
            np.testing.assert_allclose(master[n].numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-7)
    assert opt_mod.decayed("layers.0.ln1.scale", torch.zeros(4))
    assert not opt_mod.decayed("final_norm.scale", torch.zeros(4))
    assert opt_mod.decayed("lm_head", torch.zeros(4, 4))


# ------------------------------------------------------- data, compression

def test_lm_data_same_stream_for_a_seed():
    cfg = lm_data.LMDataConfig(vocab=97, seq_len=48, batch=3, seed=7)
    jcfg = j_lm_data.LMDataConfig(vocab=97, seq_len=48, batch=3, seed=7)
    ours, ref = lm_data.batches(cfg), j_lm_data.batches(jcfg)
    for _ in range(4):
        a, b = next(ours), next(ref)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].dtype == b[key].dtype


def test_quantize_matches_reference():
    x = np.random.default_rng(0).normal(size=5000).astype(np.float32)
    q, s = gc._quantize(torch.from_numpy(x))
    jq, js = j_gc._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    err = x - gc._dequantize(q, s, x.shape[0]).numpy()
    assert np.max(np.abs(err)) <= s.numpy().max() * 0.51


def test_compressed_mean_matches_reference_under_vmap():
    """Three shards with residuals: the reference's compressed_psum_mean
    under jax.vmap(axis_name=...) on one CPU device against the port's
    quantize_shards and mean_of_payloads over the same shards."""
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(3, 4100)).astype(np.float32)
    rs = (1e-3 * rng.normal(size=(3, 4100))).astype(np.float32)
    jmean, jerr = jax.vmap(
        lambda x, r: j_gc.compressed_psum_mean(x, "shards", r),
        axis_name="shards")(jnp.asarray(xs), jnp.asarray(rs))
    payloads, errs = gc.quantize_shards([torch.from_numpy(x) for x in xs],
                                        [torch.from_numpy(r) for r in rs])
    mean = gc.mean_of_payloads(payloads, xs[0].shape, torch.float32, "cpu")
    for i in range(3):
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean[i]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(errs[i].numpy(), np.asarray(jerr[i]),
                                   rtol=1e-6, atol=1e-7)


def test_ddp_step_plain_equals_microbatches_and_compressed_descends(
        monkeypatch):
    """Over 2 logical devices: the plain mean of the shards' gradients is
    make_train_step(microbatches=2) in f32; with compression both learn a
    constant batch and end near each other (tests/test_distributed.py's
    criterion)."""
    monkeypatch.setenv("REPRO_TEST_DEVICES", "2")
    jcfg = _jcfg()
    cfg = _tcfg(jcfg)
    ref = _numpy(_ref_state())
    batch = _batch(cfg.vocab, seed=4)
    opt = opt_mod.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    s_mb = train_state_from_numpy(ref, cfg, "cpu")
    step_mb = ts.make_train_step(cfg, opt, microbatches=2)
    runs = {}
    for compress in (False, True):
        state = train_state_from_numpy(
            dict(ref, residual=jax.tree.map(np.zeros_like, ref["params"])),
            cfg, "cpu", shards=2)
        step = ts.make_ddp_train_step(cfg, opt, compress=compress)
        losses = []
        for i in range(4):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if not compress:
                s_mb, m_mb = step_mb(s_mb, batch)
                assert float(m["loss"]) == pytest.approx(
                    float(m_mb["loss"]), rel=1e-6)
        runs[compress] = losses
        if compress:
            assert len(state["residual"]) == 2
            assert any(float(r["embed"].abs().max()) > 0
                       for r in state["residual"])
    for p, q in zip(state["params"].parameters(),
                    s_mb["params"].parameters()):
        assert p.shape == q.shape
    lc, lu = runs[True], runs[False]
    assert lc[-1] < lc[0] and lu[-1] < lu[0]
    assert abs(lc[-1] - lu[-1]) < 0.5 * abs(lu[0])


def test_ddp_refuses_a_grid_of_several_cards(monkeypatch):
    """(Named for the refusal it replaced: a grid of several cards now
    runs, one replica a card.) Over a ("pod", "data") = (2, 4) grid of
    logical devices the compressed step keeps one residual dict a shard
    and one replica (one distinct device) and refuses a state of other
    shards; a replica for another card copies every value; a grid of two
    cards is taken, not refused (tests/test_torch_lm_mesh.py holds the
    (2, 4) step to the reference's)."""
    from repro_torch.launch.mesh import grid_of, visible_devices
    monkeypatch.setenv("REPRO_TEST_DEVICES", "8")
    jcfg = _jcfg()
    cfg = _tcfg(jcfg)
    ref = _numpy(_ref_state())
    grid = grid_of(visible_devices("cpu"), (2, 4), ("pod", "data"))
    state = train_state_from_numpy(
        dict(ref, residual=jax.tree.map(np.zeros_like, ref["params"])),
        cfg, "cpu", shards=8)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (8, 9))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    step = ts.make_ddp_train_step(cfg, opt_mod.OptConfig(**OPT), grid)
    state, m = step(state, batch)
    assert len(state["residual"]) == 8
    assert len(ts.ddp_replicas(state)) == len(set(grid.flat)) == 1
    assert any(float(r["embed"].abs().max()) > 0 for r in state["residual"])
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="residuals"):
        step(dict(state, residual=state["residual"][:4]), batch)
    # a replica for another card: the same values in tensors of its own
    rep = ts._replica(state, torch.device("cpu"))
    for (n, p), q in zip(state["params"].named_parameters(),
                         rep["params"].parameters()):
        assert torch.equal(p, q) and p.data_ptr() != q.data_ptr(), n
        assert q.requires_grad
    for k in ("m", "v", "master"):
        for n, t in state["opt"][k].items():
            assert torch.equal(rep["opt"][k][n], t)
            assert rep["opt"][k][n].data_ptr() != t.data_ptr()
    monkeypatch.setattr(ts, "visible_devices", lambda d: (
        torch.device("cuda", 0), torch.device("cuda", 1)))
    cards = ts.ddp_grid("cuda")
    assert cards.shape == (2,) and len(set(cards.flat)) == 2


# ------------------------------------------------------ state, CLI

def test_train_state_carries_across_and_back():
    jcfg = _jcfg()
    cfg = _tcfg(jcfg)
    ref = _numpy(_ref_state())
    ref = dict(ref, residual=jax.tree.map(
        lambda x: np.full(x.shape, 0.25, np.float32), ref["params"]))
    state = train_state_from_numpy(ref, cfg, "cpu", shards=3)
    assert all(p.requires_grad for p in state["params"].parameters())
    assert len(state["residual"]) == 3
    assert state["opt"]["step"].dtype == torch.int32
    back = train_state_to_numpy(state, cfg)
    assert int(back["opt"]["step"]) == int(ref["opt"]["step"])
    for key in ("params", "residual"):
        _tree_close(back[key], ref[key], 0.0, key)
    for key in ("m", "v", "master"):
        _tree_close(back["opt"][key], ref["opt"][key], 0.0, key)
    with pytest.raises(ValueError, match="leaves"):
        bad = dict(ref, opt=dict(ref["opt"], m={"embed": ref["opt"]["m"][
            "embed"]}))
        train_state_from_numpy(bad, cfg, "cpu")


def _cli(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--steps", "8", "--batch", "2", "--seq", "16",
         *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)


def _losses(text):
    return {int(ln.split()[1]): ln.split()[3] for ln in text.splitlines()
            if ln.startswith("step ")}


def test_cli_sigterm_then_resume_gives_the_uninterrupted_losses(tmp_path):
    full = _cli([])
    out_full, err = full.communicate(timeout=240)
    assert full.returncode == 0, err
    want = _losses(out_full)
    assert sorted(want) == list(range(1, 9)) and "done" in out_full

    ck = str(tmp_path / "ck")
    run = _cli(["--ckpt", ck, "--ckpt-every", "100"])
    seen = []
    for line in run.stdout:
        seen.append(line)
        if line.startswith("step    2"):
            run.send_signal(signal.SIGTERM)
            break
    rest, err = run.communicate(timeout=240)
    text = "".join(seen) + rest
    assert run.returncode == 0, err
    assert "SIGTERM: writing final checkpoint" in text and "done" not in text
    stopped = max(_losses(text))
    assert 2 <= stopped < 8
    assert os.path.isdir(os.path.join(ck, f"step_{stopped:08d}"))

    again = _cli(["--ckpt", ck, "--ckpt-every", "100"])
    out, err = again.communicate(timeout=240)
    assert again.returncode == 0, err
    assert f"resumed from step {stopped}" in out and "done" in out
    got = _losses(out)
    assert sorted(got) == list(range(stopped + 1, 9))
    assert got == {s: want[s] for s in got}
    assert _losses(text) == {s: want[s] for s in _losses(text)}
