#!/usr/bin/env python3
"""Single-frame detection time of this checkout's port against another
checkout's, on one GPU, interleaved in one process.

    python3 tools/frame_ab.py --src OTHER/src [--reps 24]

The other checkout's ``repro_torch`` is copied to
``build/frame_ab/src/repro_torch_other`` (the package imports itself
relatively, so it loads under that name beside this one) and both build
their kernels. For the ``paper`` preset with the "kernel" backend and the
``quant`` preset, each side detects the same four seeded 640x480 scenes
(``DetectionSession.detect`` + ``block_until_ready``, score threshold
0.26) in turns, the side that goes first alternating every repetition,
so host drift falls on both alike. Prints the card, then per preset each
side's median ms/frame with its quartiles (host clock) and the pairs this
checkout won.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
PRESETS = (("paper", "kernel"), ("quant", None))
THRESHOLD = 0.26
N_FRAMES = 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the other checkout's src directory")
    ap.add_argument("--reps", type=int, default=24)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("frame_ab: FAIL: no CUDA device", file=sys.stderr)
        return 2
    other = ROOT / "build" / "frame_ab" / "src"
    shutil.rmtree(other, ignore_errors=True)
    shutil.copytree(pathlib.Path(args.src) / "repro_torch",
                    other / "repro_torch_other")
    sys.path.insert(0, str(other))
    sides = {}
    for tag, pkg in (("this", "repro_torch"), ("other", "repro_torch_other")):
        importlib.import_module(f"{pkg}.kernels.build").build_all()
        sides[tag] = importlib.import_module(f"{pkg}.api")
    synth = importlib.import_module("repro_torch.data.synth_pedestrian")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    g = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")
    svm = {"w": g["svm_w"], "b": g["svm_b"]}
    frames = [synth.make_scene(np.random.default_rng(i), 480, 640,
                               n_people=3)[0] for i in range(N_FRAMES)]
    for preset, backend in PRESETS:
        sess = {}
        for tag, api in sides.items():
            cfg = api.presets(preset)
            change = {"backend": backend} if backend else {}
            sess[tag] = api.DetectionSession(svm, cfg.replace(
                detector=dataclasses.replace(
                    cfg.detector, score_threshold=THRESHOLD, **change)))
            for f in frames:                            # warm up
                sess[tag].detect(f).block_until_ready()
        times = {tag: [] for tag in sess}
        for rep in range(args.reps):
            for tag in (("this", "other") if rep % 2 == 0
                        else ("other", "this")):
                t0 = time.perf_counter()
                for f in frames:
                    sess[tag].detect(f).block_until_ready()
                times[tag].append((time.perf_counter() - t0) * 1e3
                                  / len(frames))
        name = preset + ("+" + backend if backend else "")
        for tag, ts in times.items():
            q1, q2, q3 = statistics.quantiles(ts, n=4)
            print(f"{name} {tag}: ms/frame median {q2:.3f}, quartiles "
                  f"{q1:.3f}-{q3:.3f}", flush=True)
        won = sum(a < b for a, b in zip(times["this"], times["other"]))
        print(f"{name}: this checkout faster in {won} of {args.reps} "
              f"pairs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
