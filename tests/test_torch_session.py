"""The port's single-frame detection, end to end, against the JAX
reference session given the same weights and configuration.

Both sessions see the same seeded synthetic frame (RGB uint8) and the
golden SVM weights (tests/golden/hog_golden.npz); the port's
configuration is the reference's ``to_dict()`` carried over by
repro_torch.convert. The reference runs its Pallas kernels in interpret
mode on the CPU, the port its plain versions (device="cpu").

Compared: the top-k scores, their box indices, the NMS keep mask, the
candidate count and the decoded dicts. Boxes and the keep mask must be
identical; scores agree to 1e-4 (f32 descriptors: only summation order
differs) or 2e-3 (bf16 descriptors: a one-ulp difference in an f32 block
value can round to a neighbouring bf16 value; quant: one int8 code step
of one block element moves a window score by at most max|w| / 127 =
6.4e-4 with the golden weights, and 2e-3 allows three such steps -- the
steps come from the f32 sum of squares before the quantizer and from a
resized gray level on x.5 that rounds the other way, since the
reference's jitted resize matmul rounds in another order than the
port's; the jitted grayscale the port now rebuilds bit for bit,
core/hog.py:grayscale_fused). Where two candidates'
scores lie within that tolerance of each other the top-k order could
flip; such a case is compared as sets and says so.
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import DetectionSession as JSession
from repro.api import presets as j_presets
from repro_torch.api import DetectionSession
from repro_torch.convert import config_from_reference_dict, svm_from_numpy
from repro_torch.core.detector import FrameDetector
from repro_torch.data.synth_pedestrian import make_scene

GOLDEN = dict(np.load(pathlib.Path(__file__).parent / "golden"
                      / "hog_golden.npz"))
THRESHOLD = 0.1          # keeps 33-60 candidates and a few boxes per frame

# (preset, backend override, frame (H, W), score tolerance); each size of
# the test frames appears, and 200x150 pads into the 224x160 bucket
CASES = [
    ("paper", "kernel", (192, 128), 1e-4),
    ("perf", None, (224, 160), 2e-3),
    ("faithful", "kernel", (224, 160), 1e-4),
    ("default", None, (192, 128), 1e-4),
    ("default", None, (200, 150), 1e-4),
    ("quant", None, (224, 160), 2e-3),
    ("quant", "kernel", (192, 128), 2e-3),
]


def _configs(preset, backend):
    ref = j_presets(preset)
    det = dataclasses.replace(ref.detector, score_threshold=THRESHOLD,
                              **({"backend": backend} if backend else {}))
    ref = ref.replace(detector=det)
    return ref, config_from_reference_dict(ref.to_dict())


@pytest.mark.parametrize("preset,backend,hw,tol", CASES)
def test_detect_matches_reference_session(preset, backend, hw, tol):
    jcfg, tcfg = _configs(preset, backend)
    frame, _ = make_scene(np.random.default_rng(sum(hw)), *hw, n_people=1)
    jsess = JSession({"w": jnp.asarray(GOLDEN["svm_w"]),
                      "b": jnp.asarray(GOLDEN["svm_b"])}, jcfg)
    svm = svm_from_numpy({"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]},
                         device="cpu")
    tsess = DetectionSession(svm, tcfg, device="cpu")
    jd, td = jsess.detect(frame), tsess.detect(frame)

    assert int(td._n_valid) == int(jd._n_valid)
    jtop, ttop = np.asarray(jd._scores), td._scores.numpy()
    jidx, tidx = np.asarray(jd._index), td._index.numpy()
    np.testing.assert_allclose(ttop, jtop, rtol=0, atol=tol)
    finite = np.isfinite(jtop)
    gaps = np.diff(jtop[finite])
    if np.all(np.abs(gaps) > 2 * tol):
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_array_equal(td._keep.numpy(), np.asarray(jd._keep))
    else:
        # a near-tie within tolerance may swap neighbours in top-k order:
        # the candidate set must still match
        assert set(tidx[finite].tolist()) == set(jidx[finite].tolist())

    jl, tl = jd.to_list(), td.to_list()
    assert len(tl) == len(jl) >= 1
    assert [d["box"] for d in tl] == [d["box"] for d in jl]
    assert [d["scale"] for d in tl] == [d["scale"] for d in jl]
    np.testing.assert_allclose([d["score"] for d in tl],
                               [d["score"] for d in jl], rtol=0, atol=tol)
    np.testing.assert_array_equal(td.boxes, jd.boxes)
    assert td.saturated == jd.saturated


def test_frame_detector_call_and_bucket_match_reference():
    jcfg, tcfg = _configs("default", None)
    frame, _ = make_scene(np.random.default_rng(7), 192, 128, n_people=1)
    det = FrameDetector({"w": GOLDEN["svm_w"], "b": GOLDEN["svm_b"]},
                        tcfg.detector, device="cpu")
    assert det.bucket_for(frame) == (192, 128)
    assert det.bucket_for(np.zeros((200, 150))) == (224, 160)
    prog, ph, pw = det.program_for(200, 150)
    assert (ph, pw) == (224, 160) and prog.k == min(256, prog.n_positions)
    assert det.program_for(210, 140)[0] is prog        # one program/bucket
    got = det(frame)
    jsess = JSession({"w": jnp.asarray(GOLDEN["svm_w"]),
                      "b": jnp.asarray(GOLDEN["svm_b"])}, jcfg)
    want = jsess.detect(frame).to_list()
    assert [d["box"] for d in got] == [d["box"] for d in want]
