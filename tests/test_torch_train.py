"""The port's SVM training, hard-negative mining, session training and
detect CLI against the JAX reference (repro/core/svm.py,
repro/data/mining.py, repro/api/session.py, repro/launch/detect.py).

Pegasos: the port's step loop (core/svm.py:pegasos) is fed the
reference's own jax.random minibatch indices and held to the reference's
train_svm step by step. At every step the two active sets (the samples
with 1 - y * D(x) > 0, whose hinge passes a gradient) must be the same,
w stays within a relative L2 error of STEP_RTOL, and so do the curves of
b and of the loss over the steps: the
two differ only in the f32 summation order of the minibatch sums, and
with the learning rate at 1 throughout, a sample that crossed the margin
at another step would move w by a whole descriptor row -- so a flipped
active set is reported with its step and margin, not absorbed by a
looser tolerance.

Mining: the same person-free scenes and golden SVM (paper, backend ref)
give the same number of crops; each crop is resized in f64 here and in
f32 in the reference's own order before truncation to uint8, so every
pixel agrees within one code (the share that differs is printed).
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import presets as j_presets
from repro.core import svm as jsvm
from repro.core.hog import hog_descriptor as j_hog
from repro.data.mining import mine_hard_negatives as j_mine
from repro.data.synth_pedestrian import (PedestrianDataConfig as JData,
                                         make_dataset as j_make_dataset)
from repro_torch.api import DetectionSession, presets
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import config_from_reference_dict
from repro_torch.core import svm as tsvm
from repro_torch.core.hog import hog_descriptor
from repro_torch.data.mining import mine_hard_negatives
from repro_torch.data.synth_pedestrian import (PedestrianDataConfig,
                                               make_dataset, make_scene,
                                               make_windows)
from repro_torch.launch import detect as cli

GOLDEN = dict(np.load(pathlib.Path(__file__).parent / "golden"
                      / "hog_golden.npz"))
# w, b and the loss curve, port vs reference at each step: relative L2
# error (the minibatch sums' f32 order differs; 1.5e-7 seen at 200 steps)
STEP_RTOL = 1e-5


def _ref_trajectory(x, y01, cfg):
    """The reference's train_svm step (repro/core/svm.py:76-94), scanned
    over the same jax.random key stream, emitting each step's indices,
    the hinge argument 1 - y * D(x) before the update, and the params and
    loss after it."""
    y = y01.astype(jnp.float32) * 2.0 - 1.0
    grad_fn = jax.grad(jsvm.hinge_loss, argnums=0)

    def step(carry, t):
        params, key = carry
        key, sub = jax.random.split(key)
        idx = jax.random.randint(sub, (cfg.batch,), 0, x.shape[0])
        xb, yb = x[idx], y[idx]
        v = 1.0 - yb * jsvm.svm_score(params, xb)
        g = grad_fn(params, xb, yb, cfg.lam, cfg.neg_weight)
        lr = jnp.minimum(1.0 / (cfg.lam * (t.astype(jnp.float32) + 1.0)),
                         1.0)
        new = {"w": params["w"] - lr * g["w"], "b": params["b"] - lr * g["b"]}
        loss = jsvm.hinge_loss(new, xb, yb, cfg.lam)
        return (new, key), (idx, v, new["w"], new["b"], loss)

    _, out = jax.jit(lambda: jax.lax.scan(
        step, (jsvm.init_svm(x.shape[1]), jax.random.PRNGKey(cfg.seed)),
        jnp.arange(cfg.steps)))()
    return [np.asarray(o) for o in out]


def _rel(got, want):
    den = np.linalg.norm(np.asarray(want, np.float64))
    return float(np.linalg.norm(np.asarray(got, np.float64)
                                - np.asarray(want, np.float64))
                 / (den if den else 1.0))


def _hold_step_by_step(x, y01, steps, neg_weight):
    """Run both trainers on the reference's indices and hold them to each
    other at every step; returns the worst relative errors."""
    jcfg = jsvm.SVMTrainConfig(steps=steps, neg_weight=neg_weight)
    tcfg = tsvm.SVMTrainConfig(steps=steps, neg_weight=neg_weight)
    idx, v_ref, w_ref, b_ref, loss_ref = _ref_trajectory(
        jnp.asarray(x), jnp.asarray(y01), jcfg)
    # the emitted trajectory is the reference's train_svm
    jp, jl = jsvm.train_svm(jnp.asarray(x), jnp.asarray(y01), jcfg)
    np.testing.assert_allclose(w_ref[-1], np.asarray(jp["w"]), rtol=0,
                               atol=1e-6 * np.abs(w_ref[-1]).max())
    np.testing.assert_allclose(loss_ref, np.asarray(jl), rtol=1e-6)

    xt = torch.from_numpy(np.array(x, np.float32))
    yt = torch.from_numpy(y01.astype(np.float32) * 2.0 - 1.0)
    lrs = torch.from_numpy(tsvm.learning_rates(tcfg))
    w, b = tsvm.init_svm(x.shape[1]).values()
    worst_w, bs, losses = 0.0, [], []
    for t in range(steps):
        i = torch.from_numpy(idx[t].astype(np.int64))
        xb, yb = xt[i], yt[i]
        v = (1.0 - yb * (xb @ w + b)).numpy()
        flipped = np.flatnonzero((v > 0) != (v_ref[t] > 0))
        assert flipped.size == 0, (
            f"active sets differ at step {t}: sample {int(idx[t][flipped[0]])}"
            f" has 1 - y*D(x) {v[flipped[0]]:.9g} (port) vs "
            f"{v_ref[t][flipped[0]]:.9g} (reference)")
        w, b, loss = tsvm.pegasos_step(w, b, xb, yb, lrs[t], tcfg)
        worst_w = max(worst_w, _rel(w.numpy(), w_ref[t]))
        bs.append(float(b))
        losses.append(float(loss))
    # w at every step; the scalars b and loss as curves (b crosses zero,
    # where a per-step relative error means nothing)
    worst = {"w": worst_w, "b": _rel(bs, b_ref), "loss": _rel(losses, loss_ref)}
    assert max(worst.values()) <= STEP_RTOL, worst

    # the loop the trainer runs is the same steps
    params, losses = tsvm.pegasos(xt, yt, torch.from_numpy(
        idx.astype(np.int64)), tcfg)
    np.testing.assert_array_equal(params["w"].numpy(), w.numpy())
    assert losses.shape == (steps,)
    assert _rel(losses.numpy(), np.asarray(jl)) <= STEP_RTOL
    return worst


@pytest.mark.parametrize("neg_weight", [1.0, 6.0])
def test_pegasos_matches_reference_64_features(neg_weight):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 64)).astype(np.float32)
    y = (x @ rng.normal(size=64) > 0.3).astype(np.int32)
    _hold_step_by_step(x, y, 200, neg_weight)


@pytest.fixture(scope="module")
def windows():
    x, y = make_windows(160, 140, PedestrianDataConfig(),
                        np.random.default_rng(5))
    return x, y


@pytest.mark.parametrize("mode", ["paper", "quant"])
def test_pegasos_matches_reference_on_hog_features(windows, mode):
    """3,780 descriptor features of the reference's hog_descriptor, in
    the float (sector) and the fixed-point chain, train both. The port's
    own descriptors of the same windows follow the reference's eager
    chain (tests/test_torch_window.py); the reference's hog_descriptor
    is jitted, and XLA's contractions there (the luma's fused
    multiply-adds among them) flip a sector bin or an int8 code of a
    few elements, which the count below records."""
    x, y = windows
    feats = np.asarray(j_hog(jnp.asarray(x), j_presets(mode).hog),
                       np.float32)
    mine = hog_descriptor(torch.from_numpy(x),
                          presets(mode).hog).to(torch.float32).numpy()
    off = np.abs(mine - feats) > 1e-4
    print(f"{mode}: {int(off.sum())} of {off.size} descriptor elements "
          f"off the jitted reference's by more than 1e-4")
    assert off.mean() < 2e-3
    _hold_step_by_step(feats, y, 150, 6.0)


@pytest.mark.parametrize("name", ["default", "paper", "quant"])
def test_train_config_is_typed_and_the_reference_schedule(name):
    cfg = config_from_reference_dict(j_presets(name).to_dict())
    assert isinstance(cfg.train, tsvm.SVMTrainConfig)
    assert dataclasses.asdict(cfg.train) == \
        dataclasses.asdict(j_presets(name).train)
    assert cfg.train == presets(name).train


def test_train_svm_draws_one_schedule_on_every_device():
    cfg = tsvm.SVMTrainConfig(steps=5, batch=7, seed=11)
    a, b = tsvm.train_schedule(40, cfg), tsvm.train_schedule(40, cfg)
    assert a.shape == (5, 7) and a.dtype == torch.int64
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 40
    assert not torch.equal(a, tsvm.train_schedule(
        40, dataclasses.replace(cfg, seed=12)))


def test_learning_rates_match_reference_f32():
    cfg = tsvm.SVMTrainConfig(steps=4000, lam=1e-4)
    lr = tsvm.learning_rates(cfg)
    t = jnp.arange(4000).astype(jnp.float32)
    want = np.asarray(jnp.minimum(1.0 / (1e-4 * (t + 1.0)), 1.0))
    np.testing.assert_array_equal(lr, want)
    assert np.all(lr == 1.0)
    big = tsvm.learning_rates(dataclasses.replace(cfg, lam=0.5, steps=6))
    want = np.asarray(jnp.minimum(
        1.0 / (0.5 * (jnp.arange(6).astype(jnp.float32) + 1.0)), 1.0))
    np.testing.assert_array_equal(big, want)
    assert np.all(tsvm.learning_rates(dataclasses.replace(
        cfg, pegasos_lr=False)) == np.float32(0.1))


@pytest.mark.parametrize("neg_weight", [1.0, 3.0])
def test_hinge_loss_matches_reference(neg_weight):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(50, 12)).astype(np.float32)
    y = np.where(rng.random(50) < 0.4, -1.0, 1.0).astype(np.float32)
    w = rng.normal(size=12).astype(np.float32)
    b = np.float32(0.3)
    want = jsvm.hinge_loss({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                           jnp.asarray(x), jnp.asarray(y), 1e-2, neg_weight)
    got = tsvm.hinge_loss({"w": torch.from_numpy(w),
                           "b": torch.tensor(b)}, torch.from_numpy(x),
                          torch.from_numpy(y), 1e-2, neg_weight)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_hinge_tie_passes_half_the_gradient():
    """A margin of exactly 1 (1 - y * D(x) == 0): the reference's
    jax.grad of jnp.maximum passes 0.5 of the gradient there, and so does
    the port's closed-form step."""
    np.testing.assert_array_equal(
        tsvm.hinge_active(torch.tensor([-1.0, 0.0, 2.0])).numpy(),
        [0.0, 0.5, 1.0])
    x = np.asarray([[1.0, 2.0], [0.5, -1.0]], np.float32)
    y = np.asarray([1.0, -1.0], np.float32)
    w = np.asarray([1.0, 0.0], np.float32)       # sample 0 sits on margin 1
    b = np.float32(0.0)
    for neg_weight in (1.0, 6.0):
        g = jax.grad(jsvm.hinge_loss)(
            {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
            jnp.asarray(y), 0.0, neg_weight)
        cfg = tsvm.SVMTrainConfig(lam=0.0, neg_weight=neg_weight)
        nw, nb, _ = tsvm.pegasos_step(torch.from_numpy(w), torch.tensor(b),
                                      torch.from_numpy(x),
                                      torch.from_numpy(y), torch.tensor(1.0),
                                      cfg)
        np.testing.assert_allclose(nw.numpy(), w - np.asarray(g["w"]),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(float(nb), b - float(g["b"]), atol=1e-7)
        # the reference's gradient: the tie sample passes 0.5 of its
        # weighted row (neither 1, as clamp_min, nor 0, as relu)
        s = 1.0 + neg_weight
        np.testing.assert_allclose(np.asarray(g["w"]),
                                   -(0.5 / s) * x[0] + (neg_weight / s) * x[1],
                                   rtol=1e-6)


# ------------------------------- tests/test_svm_detector.py, on the port
def test_svm_learns_separable():
    rng = np.random.default_rng(0)
    n, f = 512, 64
    w_true = rng.normal(size=f).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x @ w_true > 0).astype(np.int32)
    params, losses = tsvm.train_svm(torch.from_numpy(x), torch.from_numpy(y),
                                    tsvm.SVMTrainConfig(steps=800, lam=1e-5))
    acc = tsvm.accuracy_table(params, torch.from_numpy(x), torch.from_numpy(y))
    assert acc["total_acc"] > 0.97
    assert float(losses[-1]) < float(losses[0])


def test_hinge_loss_zero_for_perfect_margin():
    params = {"w": torch.tensor([10.0, 0.0]), "b": torch.tensor(0.0)}
    x = torch.tensor([[1.0, 0.0], [-1.0, 0.0]])
    y = torch.tensor([1.0, -1.0])
    assert float(tsvm.hinge_loss(params, x, y, lam=0.0)) == 0.0


@pytest.mark.parametrize("nw", [0.5, 1.5, 3.0, 8.0])
def test_class_weight_monotone_effect(nw):
    """Higher neg_weight never hurts negative-class accuracy on a fixed
    imbalanced problem (property of the weighted hinge)."""
    rng = np.random.default_rng(1)
    n, f = 256, 16
    x = rng.normal(size=(n, f)).astype(np.float32)
    w_true = rng.normal(size=f).astype(np.float32)
    y = (x @ w_true > -0.8).astype(np.int32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    p1, _ = tsvm.train_svm(xt, yt, tsvm.SVMTrainConfig(steps=300,
                                                       neg_weight=1.0, seed=1))
    p2, _ = tsvm.train_svm(xt, yt, tsvm.SVMTrainConfig(steps=300,
                                                       neg_weight=nw, seed=1))
    a1 = tsvm.accuracy_table(p1, xt, yt)
    a2 = tsvm.accuracy_table(p2, xt, yt)
    if nw >= 1.0:
        assert a2["without_person_acc"] >= a1["without_person_acc"] - 0.05


def test_sign_rule_eq7():
    params = {"w": torch.tensor([1.0]), "b": torch.tensor(-0.5)}
    x = torch.tensor([[1.0], [0.0]])
    np.testing.assert_array_equal(tsvm.predict(params, x).numpy(), [1, 0])


def test_make_dataset_is_the_reference_dataset():
    kw = dict(n_pos=12, n_neg=9, n_test_pos=5, n_test_neg=4, seed=3)
    got = make_dataset(PedestrianDataConfig(**kw))
    want = j_make_dataset(JData(**kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [len(a) for a in got] == [21, 21, 9, 9]


# ------------------------------------------------------------ mining
@pytest.mark.parametrize("hw", [(160, 128), (192, 128), (224, 160)])
def test_mine_hard_negatives_matches_reference(hw):
    jcfg = j_presets("paper")
    jcfg = jcfg.replace(detector=dataclasses.replace(jcfg.detector,
                                                     backend="ref"))
    tcfg = config_from_reference_dict(jcfg.to_dict())
    want = j_mine({"w": jnp.asarray(GOLDEN["svm_w"]),
                   "b": jnp.asarray(GOLDEN["svm_b"])}, jcfg.detector, 3,
                  np.random.default_rng(1), scene_hw=hw)
    got = mine_hard_negatives({"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]},
                              tcfg.detector, 3, np.random.default_rng(1),
                              scene_hw=hw, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert len(got) >= 3                  # the comparison is not vacuous
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert int(diff.max()) <= 1
    print(f"{hw}: {len(got)} crops, pixels one code apart: "
          f"{int((diff > 0).sum())} of {diff.size}")


# ----------------------------------------------------- session and CLI
def test_session_train_is_the_composed_chain():
    """train() = make_windows + hog_descriptor + train_svm, then a mining
    round and a retrain, all on one rng stream, on the CPU."""
    cfg = presets("paper").replace(
        train=tsvm.SVMTrainConfig(steps=120, neg_weight=6.0))
    sess = DetectionSession.train(cfg, n_pos=60, n_neg=40,
                                  rng=np.random.default_rng(4),
                                  hard_negative_rounds=1, mine_scenes=1,
                                  device="cpu")
    assert sess.device.type == "cpu" and sess.svm["w"].device.type == "cpu"
    assert sess.train_losses.shape == (120,)
    assert bool(torch.isfinite(sess.train_losses).all())

    rng = np.random.default_rng(4)
    x, y = make_windows(60, 40, PedestrianDataConfig(), rng)
    feats = hog_descriptor(torch.from_numpy(x), cfg.hog)
    svm, _ = tsvm.train_svm(feats, torch.from_numpy(y), cfg.train)
    neg = mine_hard_negatives(svm, cfg.detector, 1, rng, device="cpu")
    assert sess.mined_negatives == len(neg) > 0
    feats = torch.cat([feats, hog_descriptor(torch.from_numpy(neg), cfg.hog)])
    labels = torch.cat([torch.from_numpy(y), torch.zeros(len(neg),
                                                         dtype=torch.int32)])
    svm, losses = tsvm.train_svm(feats, labels, cfg.train)
    torch.testing.assert_close(sess.svm["w"], svm["w"], rtol=0, atol=0)
    torch.testing.assert_close(sess.train_losses, losses, rtol=0, atol=0)


def _detections(out: str):
    """The CLI's printed detections and recall, timings dropped."""
    keep = []
    for line in out.splitlines():
        if line.startswith("scene "):
            keep.append(line.split(" (")[0])
        elif line.startswith(("   (", "recall")):
            keep.append(line)
    return keep


def test_cli_save_then_load_prints_the_same_detections(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    assert cli.main(["--fast", "--scenes", "1", "--device", "cpu",
                     "--save", d]) == 0
    first = capsys.readouterr().out
    assert "training SVM on 500+350 windows" in first
    assert cli.main(["--fast", "--scenes", "1", "--device", "cpu",
                     "--load", d]) == 0
    second = capsys.readouterr().out
    assert "loaded SVM params" in second and "training" not in second
    assert _detections(first) == _detections(second)
    assert len(_detections(first)) >= 3 and "recall over scenes" in first


def test_entry_points_refuse_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionSession.train("paper", n_pos=2, n_neg=2)
    sess = DetectionSession({"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]},
                            "paper", device="cpu")
    sess.save(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionSession.load(str(tmp_path), "paper")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointManager(str(tmp_path)).restore(
            0, {"w": ((3780,), torch.float32), "b": ((), torch.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mine_hard_negatives(sess.svm, sess.config.detector, 1,
                            np.random.default_rng(0), scene_hw=(160, 128))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--fast", "--scenes", "1"])
    scene, _ = make_scene(np.random.default_rng(0), 160, 128, n_people=0)
    assert isinstance(sess.detect(scene).to_list(), list)


def test_session_cache_stats_warmup_and_clear():
    """cache_stats counts the per-bucket programs the reference's does
    (repro/api/session.py:320), with the platform and call bookkeeping;
    warmup builds ahead of traffic, clear_cache drops the programs."""
    sess = DetectionSession({"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]},
                            "paper", device="cpu")
    stats = sess.warmup([(160, 128), (2, 160, 128)])
    assert stats["frame_programs"]["size"] == 1
    assert stats["warmed"] == [(2, 160, 128), (160, 128)]
    scene, _ = make_scene(np.random.default_rng(0), 150, 120, n_people=0)
    sess.detect(scene)
    stats = sess.cache_stats()
    assert stats["frame_programs"]["misses"] == 1
    assert stats["frame_programs"]["hits"] >= 2
    assert stats["calls"] == {"frames": 1, "batches": 0, "clips": 0}
    assert stats["platform"]["torch_version"] == torch.__version__
    assert stats["autotune"]["path"] is None      # conftest: disk cache off
    sess.clear_cache()
    assert sess.cache_stats()["frame_programs"]["size"] == 0
    assert sess.cache_stats()["warmed"] == []


def test_platform_seed_and_describe():
    from repro.platform import default_seed as j_default_seed
    from repro_torch import platform
    for env in ({}, {"REPRO_SEED": "7"}, {"REPRO_SEED": "x"}):
        assert platform.default_seed(env) == j_default_seed(env)
    d = platform.describe()
    assert d["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert d["device_count"] == torch.cuda.device_count()
    assert d["seed"] == platform.default_seed()


def test_session_cascade_and_its_service_rungs_build():
    """The cascade runs: session.cascade() with given coarse params builds
    the scheduler over the session's detector, and serving a
    cascade-enabled config opens the cascade rungs (a coarse head trained
    on the session's device when none is given;
    tests/test_torch_cascade.py holds both to the reference)."""
    svm = {"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]}
    sess = DetectionSession(svm, "paper", device="cpu")
    assert sess.serve().device.type == "cpu"
    casc = sess.cascade(coarse_svm={"w": np.zeros(756, np.float32),
                                    "b": np.float32(-1.0)})
    assert casc.fine is sess.detector and casc.coarse.device == sess.device
    assert casc.detect(np.zeros((240, 320, 3), np.uint8)) == []
    assert casc.stats["frames_empty"] == 1
    cascade = config_from_reference_dict(j_presets("cascade").to_dict())
    svc = DetectionSession(svm, cascade, device="cpu").serve()
    assert svc._ladder.rungs == ("full", "cascade", "coarse")
    assert svc._cascade.coarse.svm["w"].shape == (756,)
