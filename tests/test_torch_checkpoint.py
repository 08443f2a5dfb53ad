"""The port's checkpoint manager (repro_torch/checkpoint/manager.py) and
session save/load, against the reference's (repro/checkpoint/manager.py,
repro/api/session.py).

Every crash-safety case of tests/test_checkpoint_atomic.py runs on the
port's manager. The layout is the reference's byte for byte: the same
tree saved by either package gives the same files, and each package
restores the other's bit for bit, bf16 leaves included (numpy writes an
ml_dtypes bf16 leaf as 2-byte void values under the descr '<V2'; the port
writes the same bytes and reads void leaves back by the skeleton's
dtype). Sessions saved by one package detect the same boxes when loaded
in the other.
"""
import dataclasses
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.api import DetectionSession as JSession
from repro.api import presets as j_presets
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.heads import HeadRegistry
from repro_torch.api import DetectionSession
from repro_torch.checkpoint.manager import (CheckpointManager, _step_of,
                                            atomic_write_json)
from repro_torch.convert import config_from_reference_dict
from repro_torch.data.synth_pedestrian import make_scene

GOLDEN = dict(np.load(pathlib.Path(__file__).parent / "golden"
                      / "hog_golden.npz"))
TREE = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": torch.tensor(2.5)}
SKELETON = {"w": ((2, 3), torch.float32), "b": ((), torch.float32)}


def _assert_restores(mgr, step, expect_w):
    got = mgr.restore(step, SKELETON, device="cpu")
    torch.testing.assert_close(got["w"], expect_w, rtol=0, atol=0)
    assert got["b"].shape == () and float(got["b"]) == 2.5


# ---------------------- tests/test_checkpoint_atomic.py, on the port
def test_save_leaves_no_debris(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, TREE)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]
    _assert_restores(mgr, 1, TREE["w"])


def test_resave_same_step_keeps_a_valid_copy(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, TREE)
    mgr.save(1, {"w": TREE["w"] + 1, "b": TREE["b"]})
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]
    _assert_restores(mgr, 1, TREE["w"] + 1)


def test_recover_finishes_complete_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, TREE)
    os.rename(tmp_path / "step_00000002", tmp_path / "step_00000002.tmp")
    mgr2 = CheckpointManager(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    assert mgr2.latest_step() == 2
    _assert_restores(mgr2, 2, TREE["w"])


def test_recover_discards_truncated_tmp(tmp_path):
    d = tmp_path / "step_00000003.tmp"
    d.mkdir()
    (d / "w.npy").write_bytes(b"\x93NUMPY-truncat")
    mgr = CheckpointManager(str(tmp_path))
    assert os.listdir(tmp_path) == []
    assert mgr.latest_step() is None


def test_recover_restores_orphaned_old(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, TREE)
    os.rename(tmp_path / "step_00000004", tmp_path / "step_00000004.old")
    mgr2 = CheckpointManager(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_00000004"]
    _assert_restores(mgr2, 4, TREE["w"])


def test_recover_drops_superseded_old(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, TREE)
    old = tmp_path / "step_00000005.old"
    old.mkdir()
    (old / "metadata.json").write_text("{}")
    CheckpointManager(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_00000005"]


def test_latest_step_ignores_debris_and_foreign_names(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, TREE)
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000008.old").mkdir()
    (tmp_path / "heads.json").write_text("{}")
    (tmp_path / "step_notanumber").mkdir()
    assert mgr.latest_step() == 7
    assert _step_of("step_00000042") == 42
    assert _step_of("step_00000042.tmp") is None
    assert _step_of("step_00000042.old") is None
    assert _step_of("notes.txt") is None


def test_gc_keeps_newest_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, TREE)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


def test_atomic_write_json_no_truncated_reader_view(tmp_path):
    p = tmp_path / "manifest.json"
    atomic_write_json(str(p), {"v": 1}, indent=2)
    assert json.loads(p.read_text()) == {"v": 1}
    atomic_write_json(str(p), {"v": 2})
    assert json.loads(p.read_text()) == {"v": 2}
    assert sorted(os.listdir(tmp_path)) == ["manifest.json"]


def test_save_async_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(6, TREE)
    mgr.wait()
    assert mgr.latest_step() == 6
    _assert_restores(mgr, 6, TREE["w"])


def test_restore_checks_shape_and_accepts_tensor_skeletons(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, TREE)
    got = mgr.restore(1, {"w": torch.zeros(2, 3, dtype=torch.float64),
                          "b": torch.zeros(())}, device="cpu")
    assert got["w"].dtype == torch.float64
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"w": ((3, 2), torch.float32),
                        "b": ((), torch.float32)}, device="cpu")


# ------------------------------------------------ across the packages
def _trees():
    """One tree for both packages: f32, a scalar, int32, bf16, nesting."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    h = rng.normal(size=(4, 2)).astype(np.float32)
    ids = np.arange(7, dtype=np.int32)
    ref = {"w": jnp.asarray(w), "b": jnp.float32(-0.75),
           "nest": {"h": jnp.asarray(h, jnp.bfloat16),
                    "ids": [jnp.asarray(ids), jnp.asarray(ids[::-1])]}}
    port = {"w": torch.from_numpy(w), "b": torch.tensor(-0.75),
            "nest": {"h": torch.from_numpy(h).to(torch.bfloat16),
                     "ids": [torch.from_numpy(ids),
                             torch.from_numpy(ids[::-1].copy())]}}
    return ref, port


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(d).iterdir())}


def test_both_packages_write_the_same_bytes(tmp_path):
    ref, port = _trees()
    JManager(str(tmp_path / "j")).save(3, ref)
    CheckpointManager(str(tmp_path / "t")).save(3, port)
    jf = _files(tmp_path / "j" / "step_00000003")
    tf = _files(tmp_path / "t" / "step_00000003")
    assert sorted(jf) == ["b.npy", "metadata.json", "nest__h.npy",
                          "nest__ids__0.npy", "nest__ids__1.npy", "w.npy"]
    assert tf == jf


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref, port = _trees()
    JManager(str(tmp_path)).save(1, ref)
    skel = {"w": ((3, 5), torch.float32), "b": ((), torch.float32),
            "nest": {"h": ((4, 2), torch.bfloat16),
                     "ids": [((7,), torch.int32), ((7,), torch.int32)]}}
    got = CheckpointManager(str(tmp_path)).restore(1, skel, device="cpu")
    assert got["nest"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["nest"]["h"].view(torch.int16),
                       port["nest"]["h"].view(torch.int16))
    for k in ("w", "b"):
        assert torch.equal(got[k], port[k])
    for g, want in zip(got["nest"]["ids"], port["nest"]["ids"]):
        assert torch.equal(g, want)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref, port = _trees()
    CheckpointManager(str(tmp_path)).save(1, port)
    got = JManager(str(tmp_path)).restore(1, jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), ref))
    assert got["nest"]["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["nest"]["h"]).view(np.int16),
        np.asarray(ref["nest"]["h"]).view(np.int16))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_bf16_leaf_file_is_numpys_own(tmp_path):
    """The bf16 leaf's file is what np.save writes for ml_dtypes'
    bfloat16, and it loads back as void bytes in plain numpy."""
    h = np.linspace(-2, 2, 6, dtype=np.float32)
    CheckpointManager(str(tmp_path / "t")).save(0, {
        "h": torch.from_numpy(h).to(torch.bfloat16)})
    with open(tmp_path / "want.npy", "wb") as f:
        np.save(f, h.astype(ml_dtypes.bfloat16))
    got = (tmp_path / "t" / "step_00000000" / "h.npy").read_bytes()
    assert got == (tmp_path / "want.npy").read_bytes()
    assert np.load(tmp_path / "want.npy").dtype.kind == "V"


# --------------------------------------------------------- sessions
def _scene():
    frame, _ = make_scene(np.random.default_rng(31), 192, 128, n_people=1)
    return frame


def _configs():
    ref = j_presets("paper")
    ref = ref.replace(detector=dataclasses.replace(
        ref.detector, score_threshold=0.1, backend="ref"))
    return ref, config_from_reference_dict(ref.to_dict())


def _boxes(dets):
    return [d["box"] for d in dets.to_list()]


def test_reference_session_loads_in_the_port(tmp_path):
    jcfg, tcfg = _configs()
    jsess = JSession({"w": jnp.asarray(GOLDEN["svm_w"]),
                      "b": jnp.asarray(GOLDEN["svm_b"])}, jcfg)
    jsess.save(str(tmp_path), step=2)
    tsess = DetectionSession.load(str(tmp_path), tcfg, device="cpu")
    assert np.array_equal(tsess.svm["w"].numpy(), GOLDEN["svm_w"])
    frame = _scene()
    want = _boxes(jsess.detect(frame))
    assert len(want) >= 1 and _boxes(tsess.detect(frame)) == want


def test_port_session_loads_in_the_reference(tmp_path):
    jcfg, tcfg = _configs()
    tsess = DetectionSession({"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]},
                             tcfg, device="cpu")
    tsess.save(str(tmp_path))
    jsess = JSession.load(str(tmp_path), jcfg)
    assert np.array_equal(np.asarray(jsess.svm["w"]), GOLDEN["svm_w"])
    again = DetectionSession.load(str(tmp_path), tcfg, device="cpu")
    frame = _scene()
    want = _boxes(jsess.detect(frame))
    assert len(want) >= 1
    assert _boxes(tsess.detect(frame)) == want == _boxes(again.detect(frame))


def test_multi_head_directory_is_refused(tmp_path):
    """A reference registry directory (heads.json) is no longer refused:
    it loads as a multi-head session with the reference's heads, and
    detects what the reference's session loaded from it does."""
    jcfg, tcfg = _configs()
    reg = HeadRegistry()
    reg.add("person", {"w": jnp.asarray(GOLDEN["svm_w"]),
                       "b": jnp.asarray(GOLDEN["svm_b"])}, threshold=0.2)
    reg.save(str(tmp_path))
    sess = DetectionSession.load(str(tmp_path), tcfg, device="cpu")
    assert sess.registry is not None and sess.registry.names == ("person",)
    assert sess.detector.cfg.class_thresholds == (0.2,)
    frame = _scene()
    want = JSession.load(str(tmp_path), jcfg).detect(frame).to_list()
    got = sess.detect(frame).to_list()
    assert [(d["box"], d["label"]) for d in got] == \
        [(d["box"], d["label"]) for d in want]


def test_empty_directory_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        DetectionSession.load(str(tmp_path / "none"), "paper", device="cpu")
