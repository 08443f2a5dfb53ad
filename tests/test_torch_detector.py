"""The port's detector pieces (repro_torch.core.detector, api.config,
convert) against the JAX reference: resize weights, top-k order, NMS,
scoring (float and fixed), configuration carry-over, and the reference's
guards on settings.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.config import presets as j_presets
from repro.core import detector as jdet
from repro.core import quant as jquant
from repro.core.hog import HOGConfig as JHOGConfig
from repro_torch.api import DetectionSession, presets
from repro_torch.convert import config_from_reference_dict, svm_from_numpy
from repro_torch.core import detector as tdet
from repro_torch.core.detector import DetectorConfig, FrameDetector
from repro_torch.core.hog import HOGConfig

#: the 640x480 and 1280x720 frame buckets, and the 192x128 and 224x160
#: buckets of the tests' small frames (test_torch_session.py runs those
#: through the same function end to end)
BUCKETS = [(480, 640), (736, 1280), (128, 192), (160, 224)]

#: sources that are no multiple of 32, which no bucket is (shape_bucket
#: is 32): XLA pads the column sum's rows to a multiple of 32, half
#: before and half after, before it sums them in windows of 32
OFF_GRID = [(40, 32), (97, 78), (150, 120), (331, 264), (577, 461),
            (1080, 864), (2160, 1728)]


def _pairs():
    """Every (src, dst) resize the buckets' pyramid levels use."""
    out = set()
    for ph, pw in BUCKETS:
        for s in (0.8, 0.64):
            out.add((ph, int(ph * s)))
            out.add((pw, int(pw * s)))
    return sorted(out)


@pytest.mark.parametrize("src,dst", _pairs() + OFF_GRID)
def test_resize_weights_match_jax_image_resize(src, dst):
    want = jdet._resize_weights(src, dst)
    got = tdet._resize_weights(src, dst)
    assert got.shape == want.shape == (dst, src)
    assert got.dtype == np.float32
    # XLA:CPU's column sum (windows of 32 rows) rebuilt: bit for bit
    np.testing.assert_array_equal(got, want)
    # identical support: zero exactly where the reference is zero
    np.testing.assert_array_equal(got == 0, want == 0)


#: (h, w, bucket): frames already on their 32-px bucket, and frames the
#: prep edge-pads up to it
PREP_FRAMES = [(128, 192, (128, 192)), (480, 640, (480, 640)),
               (120, 180, (128, 192)), (97, 131, (128, 160))]


@pytest.mark.parametrize("h,w,bucket", PREP_FRAMES)
def test_prep_frame_gray_is_the_jitted_reference_bit_for_bit(h, w, bucket):
    """The reference runs its frame prep inside jit, where XLA fuses the
    luma into two multiply-adds; the port's grayscale_fused rebuilds that
    exactly for uint8 frames (the eager luma differs in about a fifth of
    the pixels)."""
    frame = np.random.default_rng(h * w).integers(
        0, 256, (h, w, 3)).astype(np.uint8)
    ph, pw = bucket
    want = np.asarray(jax.jit(jdet._prep_frame, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(frame), h, w, ph, pw))
    got = tdet._prep_frame(torch.from_numpy(frame), h, w, ph, pw)
    assert got.dtype == torch.float32 and got.shape == (ph, pw)
    np.testing.assert_array_equal(got.numpy(), want)
    # a gray frame passes through as f32, padded the same way
    gray = frame[..., 0]
    want = np.asarray(jax.jit(jdet._prep_frame, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(gray), h, w, ph, pw))
    np.testing.assert_array_equal(
        tdet._prep_frame(torch.from_numpy(gray), h, w, ph, pw).numpy(), want)


def test_grayscale_fused_keeps_the_eager_order_for_float_input():
    """Only uint8 has the exactness bound; float RGB keeps grayscale's
    eager order, and the window path's eager gray is unchanged."""
    from repro_torch.core.hog import grayscale, grayscale_fused
    rgb = np.random.default_rng(5).integers(0, 256, (40, 30, 3))
    as_u8 = torch.from_numpy(rgb.astype(np.uint8))
    as_f32 = torch.from_numpy(rgb.astype(np.float32))
    assert torch.equal(grayscale_fused(as_f32), grayscale(as_f32))
    fused, eager = grayscale_fused(as_u8), grayscale(as_u8)
    assert fused.dtype == eager.dtype == torch.float32
    # the two orders differ in the last bits (the eager one rounds five
    # times, the fused one three), and not everywhere
    assert 0 < int((fused != eager).sum()) < fused.numel()
    np.testing.assert_allclose(fused.numpy(), eager.numpy(), rtol=2 ** -22,
                               atol=0)


def test_top_k_tie_order_matches_lax_top_k():
    x = np.array([0.5, 0.9, 0.5, -np.inf, 0.9, 0.1, -np.inf, 0.5, -np.inf,
                  0.9], np.float32)
    for k in (3, 6, 10):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tdet.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))


def _boxes(rng, n):
    y0 = rng.uniform(0, 200, n)
    x0 = rng.uniform(0, 200, n)
    hh = rng.uniform(40, 130, n)
    ww = rng.uniform(20, 66, n)
    return np.stack([y0, x0, y0 + hh, x0 + ww], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_keep_matches_reference_and_host_greedy(seed):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, 64)
    scores = np.sort(rng.normal(0, 1, 64).astype(np.float32))[::-1].copy()
    scores[50:] = -np.inf                       # the masked top-k tail
    want = np.asarray(jdet.nms_keep(jnp.asarray(boxes), jnp.asarray(scores),
                                    0.3))
    got = tdet.nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores),
                        0.3).numpy()
    np.testing.assert_array_equal(got, want)
    greedy = sorted(tdet._nms(boxes[:50], scores[:50], 0.3))
    assert greedy == sorted(np.flatnonzero(got).tolist())
    assert greedy == sorted(jdet._nms(boxes[:50], scores[:50], 0.3))
    iou_t = tdet.matrix_iou(torch.from_numpy(boxes), torch.from_numpy(boxes))
    iou_j = jdet.matrix_iou(jnp.asarray(boxes), jnp.asarray(boxes))
    np.testing.assert_allclose(iou_t.numpy(), np.asarray(iou_j), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_score_blocks_matches_reference(dtype, use_kernel):
    rng = np.random.default_rng(2)
    blocks = rng.uniform(0, 0.4, (20, 11, 36)).astype(np.float32)
    w = rng.normal(0, 0.02, 3780).astype(np.float32)
    b = np.float32(0.125)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    want = np.asarray(jdet.score_blocks(
        jnp.asarray(blocks).astype(jdt), jnp.asarray(w), jnp.asarray(b),
        JHOGConfig(), use_kernel=use_kernel))
    got = tdet.score_blocks(torch.from_numpy(blocks).to(tdt),
                            torch.from_numpy(w), torch.tensor(b),
                            HOGConfig(), use_kernel=use_kernel)
    assert tuple(got.shape) == want.shape == (6, 5)
    # the 105-add collate runs in the reference's order; only the 36-term
    # matmul sums differ in order
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_score_blocks_fixed_bit_equal_to_reference(use_kernel):
    """The int8 scoring path on the same block grid: the grid requantizes
    to the same codes, the weights to the same codes and column scales,
    the int32 product is exact, and the rescale and the 105-add collate
    run in the reference's order, so the scores are bit-equal."""
    rng = np.random.default_rng(3)
    raw = rng.uniform(0, 0.4, (20, 11, 36)).astype(np.float32)
    raw[2, 3] = 0.0                                   # an empty block
    blocks = np.array(jquant.quantize_dequantize(jnp.asarray(raw)))
    w = rng.normal(0, 0.02, 3780).astype(np.float32)
    b = np.float32(0.125)
    fixed_j = JHOGConfig(mode="cordic", numerics="fixed")
    want = np.asarray(jdet.score_blocks(
        jnp.asarray(blocks), jnp.asarray(w), jnp.asarray(b), fixed_j,
        use_kernel=use_kernel))
    got = tdet.score_blocks(torch.from_numpy(blocks), torch.from_numpy(w),
                            torch.tensor(b),
                            HOGConfig(mode="cordic", numerics="fixed"),
                            use_kernel=use_kernel)
    assert tuple(got.shape) == want.shape == (6, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["default", "paper", "faithful", "perf",
                                  "quant"])
def test_config_carries_over_from_reference_dict(name):
    ref = j_presets(name).to_dict()
    cfg = config_from_reference_dict(ref)
    assert cfg.to_dict() == ref
    assert cfg.to_dict() == presets(name).to_dict()
    assert cfg.detector.hog == cfg.hog
    assert config_from_reference_dict(
        json.loads(cfg.to_json())) == cfg


def test_svm_from_numpy_shapes_and_device():
    g = np.random.default_rng(3)
    svm = svm_from_numpy({"w": g.normal(size=3780), "b": np.float32(0.5)},
                         device="cpu")
    assert svm["w"].dtype == torch.float32 and svm["w"].shape == (3780,)
    assert svm["b"].shape == () and svm["w"].device.type == "cpu"
    with pytest.raises(ValueError, match="expected w"):
        svm_from_numpy({"w": np.zeros(100), "b": 0.0}, device="cpu")
    # K stacked heads: (K, F) weights and (K,) biases
    stacked = svm_from_numpy({"w": g.normal(size=(2, 3780)),
                              "b": np.asarray([0.5, -0.5])}, device="cpu")
    assert stacked["w"].shape == (2, 3780) and stacked["b"].shape == (2,)
    assert stacked["w"].dtype == torch.float32
    with pytest.raises(ValueError, match="stacked"):
        svm_from_numpy({"w": np.zeros((2, 3780)), "b": np.zeros(3)},
                       device="cpu")


def _svm():
    return {"w": np.zeros(3780, np.float32), "b": np.float32(0.0)}


@pytest.mark.parametrize("change,match", [
    (dict(pyramid_resize="banded"), "banded"),
    (dict(data_parallel=0), "data_parallel"),
    (dict(data_parallel=2), "data_parallel"),
    (dict(frame_parallel=0), "frame_parallel"),
])
def test_unported_settings_raise(change, match, monkeypatch):
    """The settings earlier slices refused now behave as the reference's
    (repro/core/detector.py:632, :704): the banded resize runs,
    data_parallel=0 takes the one visible CPU, frame_parallel=0 resolves
    to one tile, and data_parallel=2 on one visible device raises the
    reference's ValueError when a batch asks for the second device."""
    monkeypatch.delenv("REPRO_TEST_DEVICES", raising=False)
    cfg = dataclasses.replace(DetectorConfig(score_threshold=-1.0),
                              **change)
    det = FrameDetector({"w": np.zeros(3780, np.float32),
                         "b": np.float32(0.25)}, cfg, device="cpu")
    frames = [np.zeros((160, 128, 3), np.uint8)] * 2
    if change.get("data_parallel") == 2:
        with pytest.raises(ValueError, match=match) as ei:
            det.detect_batch(frames)
        jcfg = dataclasses.replace(jdet.DetectorConfig(), **change)
        with pytest.raises(ValueError) as ej:
            jdet.FrameDetector(_svm(), jcfg).detect_batch(frames)
        assert str(ei.value) == str(ej.value).replace("jax.devices()",
                                                      "visible_devices()")
        return
    assert (det.data_devices, det.frame_devices) == (1, 1)
    out = det.detect_batch(frames)
    assert out[0] and out[0] == out[1] == det(frames[0])
    assert all(d["score"] == np.float32(0.25) for d in out[0])


@pytest.mark.parametrize("backend", ["ref", "kernel", "fused"])
def test_fixed_numerics_run_on_every_backend(backend):
    """numerics="fixed" is accepted and runs the fixed chain: with zero
    weights every score is the bias exactly."""
    cfg = DetectorConfig(hog=HOGConfig(mode="cordic", numerics="fixed"),
                         backend=backend, score_threshold=-1.0)
    det = FrameDetector({"w": np.zeros(3780, np.float32),
                         "b": np.float32(0.25)}, cfg, device="cpu")
    out = det(np.random.default_rng(0).integers(0, 256, (150, 80, 3))
              .astype(np.uint8))
    assert out and all(d["score"] == np.float32(0.25) for d in out)


def test_entry_points_accept_every_reference_setting(monkeypatch):
    """Stacked heads, the batched path and the multi-device settings run
    (tests/test_torch_multihead.py, test_torch_batch.py,
    test_torch_tiled.py, test_torch_sharded.py): stacked heads under
    frame_parallel=0 on one visible device run untiled, as the
    reference's (its guard fires only when a frame would tile), and
    data_parallel=2 is refused only when a batch needs the devices."""
    monkeypatch.delenv("REPRO_TEST_DEVICES", raising=False)
    det = FrameDetector({"w": np.zeros((2, 3780)), "b": np.zeros(2)},
                        device="cpu")
    assert det.heads == 2 and det.classes == ("head0", "head1")
    assert det.detect_raw(np.zeros((200, 100), np.uint8)).to_list() == []
    with pytest.raises(ValueError, match="class names"):
        FrameDetector({"w": np.zeros((2, 3780)), "b": np.zeros(2)},
                      device="cpu", classes=("a",))
    stacked = FrameDetector({"w": np.zeros((2, 3780)), "b": np.zeros(2)},
                            DetectorConfig(frame_parallel=0), device="cpu")
    assert stacked.frame_devices == 1
    assert stacked.detect_raw(np.zeros((200, 100), np.uint8)).to_list() \
        == []
    sharded = FrameDetector(_svm(), DetectorConfig(data_parallel=2),
                            device="cpu")
    with pytest.raises(ValueError, match="data_parallel=2"):
        sharded.data_devices
    det = FrameDetector(_svm(), device="cpu")
    assert det.detect_batch([np.zeros((200, 100), np.uint8)]) == [[]]
    sess = DetectionSession(_svm(), "paper", device="cpu")
    assert sess.detect_batch([np.zeros((200, 100), np.uint8)]).batch_size \
        == 1
    quant = config_from_reference_dict(j_presets("quant").to_dict())
    sess = DetectionSession(_svm(), quant, device="cpu")
    assert sess.config.hog.numerics == "fixed"
    assert sess.detector.cfg.backend == "fused"
    assert sess.detect_batch([np.zeros((200, 100), np.uint8)] * 2) \
        .to_list() == [[], []]
    with pytest.raises(ValueError, match="backend"):
        FrameDetector(_svm(), DetectorConfig(backend="pallas"),
                      device="cpu")


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    """Without a GPU, anything but an explicit CPU request raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DetectionSession(_svm(), "paper", device=device)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FrameDetector(_svm(), device=device)
    assert DetectionSession(_svm(), device="cpu").device.type == "cpu"


def test_small_frame_gives_empty_result():
    det = FrameDetector(_svm(), device="cpu")
    d = det.detect_raw(np.zeros((100, 60, 3), np.uint8))
    assert d.to_list() == [] and not d.saturated
    with pytest.raises(ValueError, match="frame"):
        det.detect_raw(np.zeros((4, 100, 60, 3), np.uint8))
