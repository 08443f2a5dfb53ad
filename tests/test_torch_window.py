"""The port's window path (repro_torch.core.pipeline, the window layout of
repro_torch.core.stages, core/hog.py:hog_descriptor, core/svm.py) against
the JAX reference on the same seeded windows, on the CPU: the port runs
its plain versions, the reference its Pallas kernels in interpret mode.

Inputs: the 3 golden windows and 11 seeded make_windows windows (a
ragged last tile against the reference's 8-window slabs).

Tolerances:
  * descriptors against the reference's window_descriptor: f32 5e-5
    (summation order), bf16 one bf16 step (2^-8, |v| <= 1), fixed one
    int8 code step in under 1e-3 of the elements (the reference's own
    contract between its backends, tests/test_fixed_point.py:221);
  * scores against the reference's jitted classify_windows: f32 1e-4,
    bf16 2e-3, fixed 2e-3. In the fixed chain the jitted reference's
    grayscale is contracted by XLA (it differs from the eager grayscale
    in the last bit, and a level on x.5 then rounds the other way), so
    there the blocks are compared with the eager reference and the
    scores with the jitted one. ``human`` must agree wherever
    |score| > the tolerance;
  * the golden fixture at tests/test_golden_reference.py's own
    tolerances: descriptors ref 2e-5, kernel and fused 5e-5; scores 5e-4.
"""
import functools
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hog as jhog
import repro.core.pipeline as jpipe
import repro.core.stages as jstages
import repro.core.svm as jsvm
import repro.data.synth_pedestrian as jsynth
from repro.api.config import presets as j_presets
from repro_torch.api import presets
from repro_torch.core import hog as thog
from repro_torch.core import pipeline, stages, svm
from repro_torch.data import synth_pedestrian as synth
from repro_torch.kernels import ops

GOLDEN = dict(np.load(pathlib.Path(__file__).parent / "golden"
                      / "hog_golden.npz"))
PRESETS = ["paper", "faithful", "perf", "quant"]
PATHS = ["ref", "kernel", "fused"]
SCORE_TOL = {"paper": 1e-4, "faithful": 1e-4, "perf": 2e-3, "quant": 2e-3}
GOLDEN_TOL = {"ref": 2e-5, "kernel": 5e-5, "fused": 5e-5}


def _windows():
    """The 3 golden windows, then 11 seeded ones: (14, 130, 66, 3) uint8."""
    xs, _ = synth.make_windows(6, 5, synth.PedestrianDataConfig(),
                               np.random.default_rng(21))
    return np.concatenate([GOLDEN["windows"], xs])


WINDOWS = _windows()
SVM_NP = {"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]}


@functools.lru_cache(maxsize=None)
def _reference(preset, path):
    """(eager window_descriptor, jitted classify_windows scores) of the
    reference on WINDOWS."""
    cfg = j_presets(preset).hog
    x = jnp.asarray(WINDOWS)
    desc = np.asarray(jstages.window_descriptor(x, cfg, path)
                      .astype(jnp.float32))
    out = jpipe.classify_windows({"w": jnp.asarray(SVM_NP["w"]),
                                  "b": jnp.asarray(SVM_NP["b"])}, x, cfg,
                                 path)
    return desc, np.asarray(out["score"]), np.asarray(out["human"])


def _assert_descriptors(preset, got, want):
    if preset == "quant":
        step = np.abs(want.reshape(-1, 36)).max(-1, keepdims=True) / 127
        diff = np.abs(got - want).reshape(-1, 36)
        assert (diff <= step + 1e-6).all(), float(diff.max())
        assert (diff > 1e-6).mean() < 1e-3
    else:
        atol = 2.0 ** -8 if preset == "perf" else 5e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("preset", PRESETS)
def test_window_descriptor_matches_reference(preset, path):
    cfg = presets(preset).hog
    got = stages.window_descriptor(torch.from_numpy(WINDOWS), cfg, path)
    assert got.dtype == (torch.bfloat16 if cfg.feat_dtype == "bf16"
                         else torch.float32)
    assert tuple(got.shape) == (14, 3780)
    _assert_descriptors(preset, got.float().numpy(),
                        _reference(preset, path)[0])


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("preset", PRESETS)
def test_classify_windows_matches_reference(preset, path):
    cfg = presets(preset).hog
    out = pipeline.classify_windows(SVM_NP, WINDOWS, cfg, path, device="cpu")
    _, score, human = _reference(preset, path)
    assert out["score"].dtype == torch.float32
    assert out["human"].dtype == torch.int32
    tol = SCORE_TOL[preset]
    np.testing.assert_allclose(out["score"].numpy(), score, rtol=0,
                               atol=tol)
    sure = np.abs(score) > tol
    assert sure.sum() >= 10
    np.testing.assert_array_equal(out["human"].numpy()[sure], human[sure])


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("preset", PRESETS)
def test_extract_features_is_window_descriptor(preset, path):
    cfg = presets(preset).hog
    got = pipeline.extract_features(WINDOWS[:5], cfg, path, device="cpu")
    want = stages.window_descriptor(torch.from_numpy(WINDOWS[:5]), cfg, path)
    assert torch.equal(got, want)


def test_perf_scoring_branches_differ_as_in_reference():
    """perf+ref rounds the weights to bf16; perf+kernel/fused score bf16
    descriptors against the f32 weights. The golden windows' reference
    scores show the gap, and each port path holds its own branch."""
    g = GOLDEN["windows"]
    cfg = presets("perf").hog
    ref = pipeline.classify_windows(SVM_NP, g, cfg, "ref", device="cpu")
    ker = pipeline.classify_windows(SVM_NP, g, cfg, "kernel", device="cpu")
    np.testing.assert_allclose(ref["score"].numpy(),
                               [0.026971, -0.000634, 0.024838], atol=2e-6)
    np.testing.assert_allclose(ker["score"].numpy(),
                               [0.026373, -0.001033, 0.024287], atol=2e-6)


@pytest.mark.parametrize("backend", PATHS)
def test_golden_descriptors_through_the_port(backend):
    got = stages.window_descriptor(torch.from_numpy(GOLDEN["windows"]),
                                   thog.PAPER_HOG, backend)
    np.testing.assert_allclose(got.numpy(), GOLDEN["descriptors"], rtol=0,
                               atol=GOLDEN_TOL[backend])


@pytest.mark.parametrize("backend", PATHS)
def test_golden_scores_through_the_port(backend):
    out = pipeline.classify_windows(SVM_NP, GOLDEN["windows"],
                                    thog.PAPER_HOG, backend, device="cpu")
    np.testing.assert_allclose(out["score"].numpy(), GOLDEN["scores"],
                               rtol=0, atol=5e-4)
    assert out["human"].tolist() == \
        (GOLDEN["scores"] > 0).astype(int).tolist()


def test_hog_descriptor_matches_reference():
    x = WINDOWS[3:7]
    want = np.asarray(jhog.hog_descriptor(jnp.asarray(x)))
    got = thog.hog_descriptor(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    assert torch.equal(thog.hog_descriptor_batch(torch.from_numpy(x)), got)


def test_larger_windows_crop_top_left_and_keep_leading_dims():
    """A 140x72 gray window crops to its top-left 130x66 (a strided view,
    made contiguous before the kernels), and leading dims survive."""
    rng = np.random.default_rng(22)
    big = rng.uniform(0, 255, (2, 3, 140, 72)).astype(np.float32)
    want = np.asarray(jstages.window_descriptor(jnp.asarray(big),
                                                jhog.PAPER_HOG, "kernel"))
    for backend in PATHS:
        got = stages.window_descriptor(torch.from_numpy(big),
                                       thog.PAPER_HOG, backend)
        assert tuple(got.shape) == (2, 3, 3780)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
        crop = stages.window_descriptor(
            torch.from_numpy(np.ascontiguousarray(big[..., :130, :66])),
            thog.PAPER_HOG, backend)
        assert torch.equal(got, crop)


@pytest.mark.parametrize("shape", [(2, 129, 66, 3), (2, 130, 65),
                                   (129, 66)])
def test_validate_window_rejects_small_windows(shape):
    x = np.zeros(shape, np.uint8 if shape[-1] == 3 else np.float32)
    with pytest.raises(ValueError, match="smaller than the configured"):
        stages.validate_window(torch.from_numpy(x), thog.PAPER_HOG)
    with pytest.raises(ValueError, match="smaller than the configured"):
        pipeline.classify_windows(SVM_NP, x, device="cpu")


def test_numpy_windows_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = GOLDEN["windows"]
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipeline.classify_windows(SVM_NP, x, device=device)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipeline.extract_features(x, device=device)
    out = pipeline.classify_windows(SVM_NP, x, device="cpu")
    assert out["score"].device.type == "cpu"


def test_tensor_windows_stay_on_their_device():
    x = torch.from_numpy(GOLDEN["windows"])
    w = torch.from_numpy(SVM_NP["w"])
    b = torch.tensor(float(SVM_NP["b"]))
    out = pipeline.classify_windows({"w": w, "b": b}, x)
    assert out["score"].device == x.device
    with pytest.raises(ValueError, match="SVM parameter"):
        pipeline.classify_windows({"w": w.to("meta"), "b": b}, x)
    with pytest.raises(ValueError, match="was asked for"):
        pipeline.classify_windows({"w": w, "b": b}, x.to("meta"),
                                  device="cpu")
    with pytest.raises(ValueError, match="backend"):
        pipeline.classify_windows({"w": w, "b": b}, x, path="pallas")


def test_make_windows_matches_reference():
    for seed in (0, 5):
        got = synth.make_windows(4, 3, synth.PedestrianDataConfig(),
                                 np.random.default_rng(seed))
        want = jsynth.make_windows(4, 3, jsynth.PedestrianDataConfig(),
                                   np.random.default_rng(seed))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_svm_inference_matches_reference():
    rng = np.random.default_rng(23)
    x = rng.normal(0, 1, (40, 3780)).astype(np.float32)
    y = rng.integers(0, 2, 40).astype(np.int32)
    p_np = {"w": rng.normal(0, 0.02, 3780).astype(np.float32),
            "b": np.float32(0.05)}
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in p_np.items()}
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    np.testing.assert_allclose(svm.svm_score(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jsvm.svm_score(jp, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    got = svm.accuracy_table(tp, torch.from_numpy(x), torch.from_numpy(y))
    want = jsvm.accuracy_table(jp, jnp.asarray(x), jnp.asarray(y))
    assert got == want
    init = svm.init_svm(3780)
    assert tuple(init["w"].shape) == (3780,) and float(init["b"]) == 0.0
    assert svm.predict(init, torch.from_numpy(x)).sum() == 0


def test_ops_wrappers_are_the_stage_chain():
    x = torch.from_numpy(GOLDEN["windows"])
    cfg = presets("paper").hog
    assert torch.equal(ops.hog_descriptor_kernel(x, cfg),
                       stages.window_descriptor(x, cfg, "kernel"))
    assert torch.equal(ops.hog_descriptor_fused(x, cfg),
                       stages.window_descriptor(x, cfg, "fused"))
    f = ops.hog_descriptor_fused(x, cfg)
    w = torch.from_numpy(SVM_NP["w"])
    b = torch.tensor(float(SVM_NP["b"]))
    torch.testing.assert_close(ops.svm_score_kernel(f, w, b), f @ w + b,
                               rtol=0, atol=1e-6)


def test_dense_layout_unchanged_by_the_window_layout():
    """A 130x66 scene through the dense layout is one window's block
    grid: the two layouts agree per backend and mode."""
    g = np.random.default_rng(24).integers(0, 256, (2, 130, 66)) \
        .astype(np.float32)
    for cfg in (presets("paper").hog, presets("faithful").hog,
                presets("quant").hog):
        for backend in PATHS:
            d = stages.dense_blocks(torch.from_numpy(g), cfg, backend)
            w = stages.window_blocks(torch.from_numpy(g), cfg, backend)
            assert torch.equal(d, w)
    with pytest.raises(ValueError, match="layout"):
        stages.run_stages(torch.from_numpy(g), presets("paper").hog,
                          layout="tiles")
