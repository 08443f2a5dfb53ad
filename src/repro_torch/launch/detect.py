"""Detection launcher, the port of repro/launch/detect.py: one
DetectionSession end to end -- train or load an SVM, run the multi-scale
detector on synthetic scenes, report recall and top-k saturation.

Repeated runs skip the SVM train: ``--save DIR`` checkpoints the params
after training (checkpoint/manager.py atomic layout, loadable by either
package), ``--load DIR`` restores them (falling back to training, then
saving if --save was also given -- so ``--load D --save D`` is "train
once, reuse forever"). Everything runs on the card unless ``--device
cpu`` is given.

Usage: PYTHONPATH=src python -m repro_torch.launch.detect
           [--scenes 3] [--fast] [--backend ref|kernel|fused]
           [--preset paper|faithful|perf|quant|default]
           [--save DIR] [--load DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

from .. import platform
from ..api import DetectionSession, PipelineConfig, presets
from ..core.detector import DetectorConfig
from ..core.svm import SVMTrainConfig
from ..data.synth_pedestrian import (PedestrianDataConfig, make_scene,
                                     make_windows)


def build_config(args) -> PipelineConfig:
    if args.preset:
        # keep the preset's detector (backend, batch_chunk, ...);
        # --backend, when given explicitly, overrides it
        base = presets(args.preset)
        det = dataclasses.replace(
            base.detector, score_threshold=0.5,
            backend=args.backend or base.detector.backend)
        return base.replace(detector=det)
    return PipelineConfig(
        detector=DetectorConfig(score_threshold=0.5,
                                backend=args.backend or "ref"),
        train=SVMTrainConfig(steps=2500, neg_weight=6.0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--backend", default=None,
                    choices=["ref", "kernel", "fused"],
                    help="stage backend for the dense HOG pass "
                         "(default: the preset's backend, else ref)")
    ap.add_argument("--preset", default=None, choices=list(presets()),
                    help="PipelineConfig preset (numerics + train "
                         "schedule); default keeps the ref datapath")
    ap.add_argument("--save", metavar="DIR", default=None,
                    help="checkpoint the trained SVM params here")
    ap.add_argument("--load", metavar="DIR", default=None,
                    help="restore SVM params instead of training "
                         "(falls back to training if DIR is empty)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where everything runs (default: the GPU; "
                         "without one, only cpu runs)")
    args = ap.parse_args(argv)

    cfg = build_config(args)
    n_pos, n_neg = (500, 350) if args.fast else (1500, 1000)

    # one rng stream for training windows AND evaluation scenes (scenes
    # are drawn from the post-train state); REPRO_SEED overrides
    rng = np.random.default_rng(platform.default_seed())
    session = None
    if args.load:
        try:
            session = DetectionSession.load(args.load, cfg,
                                            device=args.device)
            print(f"loaded SVM params from {args.load} "
                  f"(skipping the {cfg.train.steps}-step train)")
            # advance the stream by the skipped window draws so the
            # scenes below are identical to a train-path run
            make_windows(n_pos, n_neg, PedestrianDataConfig(), rng)
        except FileNotFoundError:
            print(f"no checkpoint under {args.load}; training")
    if session is None:
        print(f"training SVM on {n_pos}+{n_neg} windows "
              f"({cfg.train.steps} steps) ...")
        session = DetectionSession.train(cfg, n_pos=n_pos, n_neg=n_neg,
                                         rng=rng, device=args.device)
        if args.save:
            session.save(args.save)
            print(f"saved SVM params to {args.save}")

    hits = 0
    for i in range(args.scenes):
        scene, truth = make_scene(rng, 320, 240, n_people=2)
        t0 = time.perf_counter()
        result = session.detect(scene)
        dets = result.to_list()
        ms = (time.perf_counter() - t0) * 1e3
        tag = "compile+run" if i == 0 else "steady"
        sat = " [top-k saturated]" if result.saturated else ""
        print(f"scene {i}: {len(truth)} people, {len(dets)} detections "
              f"({ms:.1f} ms {tag}){sat}")
        for d in dets[:4]:
            y0, x0, y1, x1 = d["box"]
            print(f"   ({y0:5.0f},{x0:5.0f})-({y1:5.0f},{x1:5.0f}) "
                  f"score={d['score']:.2f}")
        for (ty, tx, th, tw) in truth:
            ok = any(abs(d["box"][0] - ty) < 32 and abs(d["box"][1] - tx) < 32
                     for d in dets)
            hits += ok
    print(f"recall over scenes: {hits}/{2*args.scenes}")
    stats = session.cache_stats()
    print(f"compiled programs: {stats['frame_programs']['size']} "
          f"(hits {stats['frame_programs']['hits']})")
    plat = stats["platform"]
    print(f"platform: {session.device.type} x{plat['device_count']} "
          f"({plat['device_kind'] or 'no GPU'}) "
          f"torch={plat['torch_version']} cuda={plat['cuda_version']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
