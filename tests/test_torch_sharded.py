"""The port's sharded (data-parallel) batches over REPRO_TEST_DEVICES
logical CPU devices, each equal to the single-device batch bit for bit
(``Detections.to_list()``), as tests/test_sharded.py holds the
reference's: B divisible and not divisible by dp (zero-frame padding),
mixed true sizes, the wide schedule, fixed numerics and the fused
backend; the autotune key's mesh; the ``sharded`` session's warmup and
stats; the service's frame target; and the device grids' and resolvers'
ValueErrors against the reference's messages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import presets as j_presets
from repro.core import detector as jdet
from repro.launch import mesh as jmesh
from repro_torch.api import DetectionSession, presets
from repro_torch.configs import hog_svm
from repro_torch.convert import config_from_reference_dict
from repro_torch.core import detector as tdet
from repro_torch.core.detector import DetectorConfig, FrameDetector
from repro_torch.core.hog import PAPER_HOG
from repro_torch.launch import mesh
from repro_torch.serve.engine import DetectionService

RNG = np.random.default_rng(19)
SVM = {"w": RNG.normal(size=3780).astype(np.float32) * .01,
       "b": np.float32(0.0)}
N_DEV = 4


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("REPRO_TEST_DEVICES", str(N_DEV))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # small shapes and many small ops: one intra-op thread runs them
    # fastest, and keeps them fast beside other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, h=160, w=128):
    return RNG.integers(0, 256, (n, h, w, 3)).astype(np.uint8)


def _equal(base, frames, **sharded):
    single = FrameDetector(SVM, dataclasses.replace(base, data_parallel=1),
                           device="cpu")
    shard = FrameDetector(SVM, dataclasses.replace(
        base, **{"data_parallel": 0, **sharded}), device="cpu")
    want = single.detect_batch_raw(frames)
    got = shard.detect_batch_raw(frames)
    assert got.batch_size == want.batch_size == len(frames)
    assert got.to_list() == want.to_list()
    assert np.array_equal(got.saturated, want.saturated)
    assert got._scores.device == shard.device
    return shard, got


@pytest.mark.parametrize("mode", ["ref", "sector", "cordic"])
@pytest.mark.parametrize("n", [N_DEV, N_DEV + 3, 1])
def test_sharded_equals_single_device(mode, n):
    """B a multiple of dp, B padded up by zero frames, and B below dp."""
    hog = dataclasses.replace(PAPER_HOG, mode=mode)
    base = DetectorConfig(hog=hog, score_threshold=-10.0, scales=(1.0, 0.8),
                          batch_chunk=1)
    det, got = _equal(base, _frames(n))
    assert det.data_devices == N_DEV
    assert all(got.to_list())


@pytest.mark.parametrize("backend,hog,chunk", [
    ("ref", hog_svm.QUANT, 1),          # fixed numerics
    ("fused", hog_svm.QUANT, 2),
    ("fused", hog_svm.PERF, 16),        # bf16 descriptors, wide schedule
    ("kernel", PAPER_HOG, 0),           # autotuned
])
def test_sharded_numerics_and_backends_equal_single_device(backend, hog,
                                                           chunk):
    base = DetectorConfig(hog=hog, backend=backend, score_threshold=-10.0,
                          scales=(1.0, 0.8), batch_chunk=chunk)
    for n in (N_DEV, N_DEV + 3):
        _equal(base, _frames(n))
    _equal(base, _frames(3), data_parallel=2)


def test_sharded_mixed_true_sizes_one_bucket():
    """Mixed true sizes in one bucket take the pre-padded gray path; each
    frame keeps its own inside mask through the split."""
    fa = RNG.integers(0, 256, (150, 120, 3)).astype(np.uint8)
    fb = RNG.integers(0, 256, (160, 128, 3)).astype(np.uint8)
    base = DetectorConfig(score_threshold=-10.0, scales=(1.0,),
                          batch_chunk=1)
    _, got = _equal(base, [fa, fb, fa, fb, fa])
    assert got.to_list()[0] != got.to_list()[1]


def test_autotune_key_carries_the_resolved_mesh():
    """The key and its report carry the resolved dp and fp; the sharded
    probe keys on the padded batch and schedules each device's local
    sub-batch; a second call hits the memory."""
    frames = _frames(N_DEV + 1)                      # pads to 2 * N_DEV
    det = FrameDetector(SVM, DetectorConfig(
        score_threshold=-10.0, scales=(1.0,), batch_chunk=0,
        data_parallel=0), device="cpu")
    first = det.detect_batch(frames)
    rep = tdet.autotune_report()
    key = [k for k in rep if f"B={2 * N_DEV} mesh=data:{N_DEV} " in k]
    assert len(key) == 1 and key[0].endswith("on cpu"), rep
    assert set(rep[key[0]]["probe_ms"]) == {1, 2}    # local B 2
    assert det.detect_batch(frames) == first
    assert tdet.autotune_report()[key[0]] == rep[key[0]]
    tiled = FrameDetector(SVM, DetectorConfig(
        score_threshold=-10.0, scales=(1.0,), batch_chunk=0,
        data_parallel=2, frame_parallel=2), device="cpu")
    assert tiled.detect_batch(frames) == first
    assert any("mesh=data:2,tile:2 " in k for k in tdet.autotune_report())
    assert tdet._autotune_key_str(
        (160, 128, 160, 128, 4, None, "rgb-uint8", 2, 2, 0, "cuda")) \
        == jdet._autotune_key_str(
            (160, 128, 160, 128, 4, None, "rgb-uint8", 2, 2)) + " on cuda"


def test_sharded_session_warmup_and_stats():
    """presets("sharded") resolves to every device; warmup builds the
    sharded batch (a B that pads included), cache_stats reports the mesh
    as the reference's does, and the warmed shape's traffic builds no
    new program."""
    ref = j_presets("sharded")
    assert config_from_reference_dict(ref.to_dict()) == presets("sharded")
    cfg = presets("sharded").replace(detector=dataclasses.replace(
        presets("sharded").detector, score_threshold=-10.0, scales=(1.0,)))
    ses = DetectionSession(SVM, cfg, device="cpu")
    assert ses.data_devices == N_DEV
    stats = ses.warmup([(160, 128), (N_DEV + 1, 160, 128)])
    assert stats["mesh"] == {"data_parallel": 0, "devices": N_DEV,
                             "frame_parallel": 1, "tile_devices": 1}
    before = ses.cache_stats()["frame_programs"]["misses"]
    got = ses.detect_batch(_frames(N_DEV + 1))
    assert ses.cache_stats()["frame_programs"]["misses"] == before
    assert got.batch_size == N_DEV + 1
    bad = DetectionSession(SVM, cfg.replace(detector=dataclasses.replace(
        cfg.detector, data_parallel=N_DEV + 1)), device="cpu")
    assert bad.cache_stats()["mesh"]["devices"] is None


def test_service_coalesces_to_the_device_target():
    """The service's per-dispatch frame target scales with the data axis,
    and its stats split the frames per device."""
    cfg = DetectorConfig(score_threshold=-10.0, scales=(1.0,),
                         data_parallel=0, batch_chunk=1)
    svc = DetectionService(SVM, detector=cfg, frame_batch=2,
                           max_wait_ms=200.0, device="cpu")
    assert svc.devices == N_DEV and svc.frame_target == 2 * N_DEV
    assert svc.stats["devices"] == N_DEV
    assert len(svc.stats["per_device_occupancy"]) == N_DEV
    frames = list(_frames(2 * N_DEV))
    futs = [svc.submit_frame(f) for f in frames]     # queue, then start
    svc.start()
    try:
        single = FrameDetector(SVM, dataclasses.replace(cfg, data_parallel=1),
                               device="cpu")
        for fut, f in zip(futs, frames):
            res = fut.get(timeout=120)
            assert "error" not in res
            assert res["detections"] == single(f)
    finally:
        svc.stop()
    assert svc.stats["frames"] == 2 * N_DEV
    assert sum(svc.stats["device_frames"]) == 2 * N_DEV


def test_visible_devices_and_grids(monkeypatch):
    cpu = torch.device("cpu")
    assert mesh.visible_devices("cpu") == (cpu,) * N_DEV
    grid = mesh.make_tiled_mesh(2, 0, "cpu")
    assert grid.axis_names == ("data", "tile") and grid.shape == (2, 2)
    assert grid.size == N_DEV and grid.devices[1] == (cpu, cpu)
    assert mesh.make_detection_mesh(device="cpu").shape == (N_DEV,)
    monkeypatch.delenv("REPRO_TEST_DEVICES")
    assert mesh.visible_devices("cpu") == (cpu,)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.visible_devices() == (torch.device("cuda", 0),
                                      torch.device("cuda", 1))
    assert mesh.forced_devices({"REPRO_TEST_DEVICES": ""}) == 0


def _ref_message(call):
    with pytest.raises(ValueError) as ei:
        call()
    return str(ei.value).replace("jax.devices()", "visible_devices()")


def test_guards_raise_the_reference_errors(monkeypatch):
    """Each guard against the reference's on the same device count."""
    n = jax.device_count()
    monkeypatch.setenv("REPRO_TEST_DEVICES", str(n))
    cases = [
        (lambda: mesh.make_detection_mesh(n + 1, "cpu"),
         lambda: jmesh.make_detection_mesh(n + 1)),
        (lambda: mesh.make_tiled_mesh(1, n + 1, "cpu"),
         lambda: jmesh.make_tiled_mesh(1, n + 1)),
        (lambda: mesh.make_tiled_mesh(n + 1, 1, "cpu"),
         lambda: jmesh.make_tiled_mesh(n + 1, 1)),
        (lambda: mesh.make_tiled_mesh(-1, 1, "cpu"),
         lambda: jmesh.make_tiled_mesh(-1, 1)),
        (lambda: FrameDetector(SVM, DetectorConfig(
            frame_parallel=n + 1), device="cpu").frame_devices,
         lambda: jdet._resolve_fp(jdet.DetectorConfig(frame_parallel=n + 1))),
        (lambda: FrameDetector(SVM, DetectorConfig(
            data_parallel=n + 1), device="cpu").detect_batch(_frames(2)),
         lambda: jdet._resolve_dp(jdet.DetectorConfig(data_parallel=n + 1))),
        (lambda: tdet._tile_local_fn(None, 160, 128, 2, 0, DetectorConfig(
            tile_mode="rows")),
         lambda: jdet._tile_local_fn(160, 128, 2, jdet.DetectorConfig(
             tile_mode="rows"))),
    ]
    for port, ref in cases:
        assert _ref_message(port) == _ref_message(ref)
    for mode in ("matmul", "banded"):
        FrameDetector(SVM, DetectorConfig(pyramid_resize=mode), device="cpu")
    with pytest.raises(ValueError, match="pyramid_resize"):
        FrameDetector(SVM, DetectorConfig(pyramid_resize="bicubic"),
                      device="cpu")
