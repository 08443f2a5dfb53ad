"""The port's tiled (frame-parallel) detection: single frames and batches
tiled over REPRO_TEST_DEVICES logical CPU devices against the port's own
untiled result, bit for bit (``Detections.to_list()``), as
tests/test_tiled.py holds the reference's; and the ``uhd`` preset against
the reference's untiled banded program.

Every tiled case runs on the CPU, the tiles of one frame one after
another on one device: "slab" and "scale" modes, fp 2, 3 (the slabs do
not divide the score rows) and 4 (slab overhang tiles, and empty scale
groups over two scales), the banded and the matmul resize, backends
"ref", "kernel" and "fused" (the plain versions here) and the fixed
numerics.
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DetectionSession as JSession
from repro.api import presets as j_presets
from repro_torch.api import DetectionSession, presets
from repro_torch.configs import hog_svm
from repro_torch.convert import config_from_reference_dict
from repro_torch.core.detector import DetectorConfig, FrameDetector
from repro_torch.core.hog import PAPER_HOG
from repro_torch.core.tiling import slab_rows
from repro_torch.data.synth_pedestrian import make_scene

RNG = np.random.default_rng(23)
SVM = {"w": RNG.normal(size=3780).astype(np.float32) * .01,
       "b": np.float32(0.0)}
GOLDEN = dict(np.load(pathlib.Path(__file__).parent / "golden"
                      / "hog_golden.npz"))
FRAME = RNG.integers(0, 256, (200, 144, 3)).astype(np.uint8)
SCENE = make_scene(np.random.default_rng(5), 224, 176, n_people=2)[0]

#: backend -> (HOG config, stage backend)
BACKENDS = {"ref": (PAPER_HOG, "ref"), "kernel": (PAPER_HOG, "kernel"),
            "fused": (hog_svm.PERF, "fused"),
            "fixed": (hog_svm.QUANT, "fused")}


@pytest.fixture(autouse=True)
def four_devices(monkeypatch):
    monkeypatch.setenv("REPRO_TEST_DEVICES", "4")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # small shapes and many small ops: one intra-op thread runs them
    # fastest, and keeps them fast beside other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _base(backend="ref", resize="banded", **change):
    hog, stages = BACKENDS[backend]
    return DetectorConfig(hog=hog, backend=stages, score_threshold=-5.0,
                          scales=(1.0, 0.8), pyramid_resize=resize,
                          **change)


def _pair(base, frame, **tiled):
    want = FrameDetector(SVM, base, device="cpu").detect_raw(frame)
    det = FrameDetector(SVM, dataclasses.replace(base, **tiled),
                        device="cpu")
    return want.to_list(), det.detect_raw(frame), det


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("resize", ["banded", "matmul"])
@pytest.mark.parametrize("mode", ["slab", "scale"])
@pytest.mark.parametrize("fp", [2, 3, 4])
def test_tiled_frame_equals_untiled(backend, resize, mode, fp):
    want, got, det = _pair(_base(backend, resize), FRAME,
                           frame_parallel=fp, tile_mode=mode)
    assert det.frame_devices == fp and det._tiled_steps
    assert want, "the threshold must admit boxes or the test is vacuous"
    assert got.to_list() == want
    assert got._index.dtype == torch.int64


@pytest.mark.parametrize("resize,mode", [("banded", "slab"),
                                         ("matmul", "scale")])
def test_tiled_scene_with_the_golden_svm_equals_untiled(resize, mode):
    """People in a seeded scene, the golden SVM at a real threshold."""
    svm = {"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]}
    base = DetectorConfig(score_threshold=0.1, pyramid_resize=resize)
    want = FrameDetector(svm, base, device="cpu").detect_raw(SCENE)
    for fp in (2, 4):
        got = FrameDetector(svm, dataclasses.replace(
            base, frame_parallel=fp, tile_mode=mode), device="cpu"
        ).detect_raw(SCENE)
        assert want.to_list() and got.to_list() == want.to_list()
        assert int(got._n_valid) == int(want._n_valid)


def test_tiled_keeps_seam_straddling_boxes():
    """With a 160-row frame and fp 2 the level-1.0 seam sits at scaled
    row 3 * 8 = 24: kept 128-row windows of score rows 0-2 cross it."""
    frame = RNG.integers(0, 256, (160, 128, 3)).astype(np.uint8)
    want, got, _ = _pair(_base(), frame, frame_parallel=2)
    assert got.to_list() == want
    seam_y = slab_rows(5, 2) * PAPER_HOG.cell
    assert [d for d in want if d["box"][0] < seam_y < d["box"][2]], \
        "no kept box straddles the slab seam"


@pytest.mark.parametrize("dp,fp,chunk", [(2, 2, 1), (1, 4, 0), (2, 2, 0),
                                         (1, 3, 2)])
def test_tiled_batch_equals_untiled(dp, fp, chunk):
    """The 2-D (data x tile) schedule over 3 frames (dp 2 pads one zero
    frame), and the tile axis alone, against the untiled batch and each
    frame's own detect; ``batch_chunk=0`` autotunes the routed program."""
    frames = np.stack([RNG.integers(0, 256, (160, 128, 3)).astype(np.uint8)
                       for _ in range(3)])
    base = _base(batch_chunk=chunk)
    plain = FrameDetector(SVM, base, device="cpu")
    want = plain.detect_batch_raw(frames)
    tiled = FrameDetector(SVM, dataclasses.replace(
        base, data_parallel=dp, frame_parallel=fp), device="cpu")
    got = tiled.detect_batch_raw(frames)
    assert got.batch_size == 3 and got.to_list() == want.to_list()
    assert got.to_list() == [plain(f) for f in frames]
    assert np.array_equal(got.saturated, want.saturated)


def test_area_threshold_routes_small_frames_untiled():
    """A bucket below frame_parallel_min_area runs the untiled program:
    the same result, and no tiled step is built."""
    base = _base()
    want, got, det = _pair(base, FRAME, frame_parallel=0,
                           frame_parallel_min_area=10 ** 9)
    assert det.frame_devices == 4 and det._tiled_for(224, 160) == 1
    assert got.to_list() == want and not det._tiled_steps
    # at the threshold exactly, the frame tiles
    at = FrameDetector(SVM, dataclasses.replace(
        base, frame_parallel=0, frame_parallel_min_area=224 * 160),
        device="cpu")
    assert at.detect_raw(FRAME).to_list() == want and at._tiled_steps


def test_uhd_preset_equals_the_reference_untiled_banded(monkeypatch):
    """presets("uhd") on one 1280x720 scene: tiled over 4 logical devices
    (the 736x1280 bucket clears its 1280x720 area) and untiled on one
    device, equal bit for bit; both against the reference's untiled
    banded program (its jitted resize contracts to fused multiply-adds,
    the port's does not): the same boxes, scores within 1e-4."""
    frame = make_scene(np.random.default_rng(7), 720, 1280, n_people=3)[0]
    svm = {"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]}
    assert config_from_reference_dict(j_presets("uhd").to_dict()) \
        == presets("uhd")
    # the golden SVM's scores on synthetic scenes sit below the preset's
    # 0.5: 0.25 keeps a few dozen candidates, under K
    jcfg = j_presets("uhd").replace(detector=dataclasses.replace(
        j_presets("uhd").detector, score_threshold=0.25))
    cfg = config_from_reference_dict(jcfg.to_dict())
    tiled = DetectionSession(svm, cfg, device="cpu")
    assert tiled.detector.frame_devices == 4
    got = tiled.detect(frame)
    assert tiled.detector._tiled_steps
    monkeypatch.delenv("REPRO_TEST_DEVICES")
    one = DetectionSession(svm, cfg, device="cpu")
    assert one.detector.frame_devices == 1
    untiled = one.detect(frame)
    assert got.to_list() == untiled.to_list() and got.to_list()
    ref = JSession({"w": jnp.asarray(svm["w"]), "b": jnp.asarray(svm["b"])},
                   jcfg).detect(frame)
    assert int(got._n_valid) == int(ref._n_valid)
    mine, theirs = got.to_list(), ref.to_list()
    assert [d["box"] for d in mine] == [d["box"] for d in theirs]
    np.testing.assert_allclose([d["score"] for d in mine],
                               [d["score"] for d in theirs], rtol=0,
                               atol=1e-4)
