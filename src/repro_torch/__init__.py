"""PyTorch + CUDA port of the HOG+SVM human detector (Nguyen et al. 2022).

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``repro_torch/core/hog.py`` <-> ``repro/core/hog.py``, ...)
and imports nothing of it, nor JAX. Plain tensor code is PyTorch; every
TPU kernel on the ported path is a CUDA kernel written for Hopper
(csrc/, built by kernels/build.py at first use).

What runs: SVM training with hard-negative mining and checkpoints --
``api.DetectionSession.train`` / ``save`` / ``load`` over ``core.svm``,
``data.mining`` and ``checkpoint.manager``, and the detect CLI
(``launch.detect``); dense multi-scale detection of a frame, a batch and
a tracked clip -- ``api.DetectionSession.detect`` / ``detect_batch`` /
``stream`` -> ``core.detector.FrameDetector`` -- and window
classification -- ``core.pipeline.classify_windows`` and
``extract_features`` -- for the float presets (default, paper, faithful,
perf) and the fixed-point ``quant`` preset; and LM serving for the dense
family -- ``serve.engine.generate`` over ``models/`` (prefill through the
flash-attention kernel, then the decode loop).
"""
