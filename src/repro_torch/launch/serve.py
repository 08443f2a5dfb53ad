"""Serving launcher of the port (the port of repro/launch/serve.py), two
smokes behind one CLI:

LM mode (default): --arch <id> prefill + decode a batch of prompts with
the KV cache at smoke size and print tokens/s. The dense family runs;
the other families raise the registry's NotImplementedError.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --batch 4 --prompt-len 16 --new-tokens 32 [--device cpu]

Detection mode: --detect builds a DetectionSession (training a quick SVM
or loading one with --load), starts session.serve() -- the
micro-batching DetectionService -- streams synthetic frames through it,
and prints per-frame latency, saturation, and service stats.

    PYTHONPATH=src python -m repro_torch.launch.serve --detect
        [--frames 6] [--preset paper] [--load DIR] [--device cpu]

`--detect --chaos` replays the standard fault-injection schedule
(serve/faults.py chaos_specs: worker kill, device loss, latency spikes)
through the supervised engine and exits nonzero unless every submitted
frame resolved. `--detect --metrics PATH` streams the service's
structured telemetry (DESIGN.md §15 event schema) to a JSONL file you can
`tail -f`. Everything runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import sys
import time


def _detect_smoke(args) -> int:
    import numpy as np

    from ..api import DetectionSession, PipelineConfig, presets
    from ..core.detector import DetectorConfig
    from ..core.svm import SVMTrainConfig
    from ..data.synth_pedestrian import make_scene

    if args.preset:
        cfg = presets(args.preset)
    else:
        cfg = PipelineConfig(
            detector=DetectorConfig(score_threshold=0.5),
            train=SVMTrainConfig(steps=1200, neg_weight=6.0))

    session = None
    if args.load:
        try:
            session = DetectionSession.load(args.load, cfg,
                                            device=args.device)
            print(f"loaded SVM params from {args.load}")
        except FileNotFoundError:
            print(f"no checkpoint under {args.load}; training")
    if session is None:
        print(f"training a quick SVM ({cfg.train.steps} steps) ...")
        session = DetectionSession.train(cfg, n_pos=500, n_neg=350,
                                         device=args.device)

    opts = {}
    if args.chaos:
        from ..serve.faults import FaultInjector, chaos_specs
        opts["faults"] = FaultInjector(chaos_specs(), seed=0)
        print("chaos: injecting worker-kill, device-loss, and latency "
              "faults (serve/faults.py chaos_specs)")
    if args.metrics:
        from ..obs import MetricsConfig
        opts["metrics"] = MetricsConfig(jsonl_path=args.metrics, ring=64)
        print(f"metrics: streaming JSONL events to {args.metrics} "
              f"(tail -f it in another terminal)")
    service = session.serve(**opts).start()
    rng = np.random.default_rng(0)
    frames = [make_scene(rng, 240, 320, n_people=2)[0]
              for _ in range(args.frames)]
    print(f"streaming {args.frames} 320x240 frames through "
          f"session.serve() ...")
    t0 = time.time()
    results = service.detect_frames(frames)
    wall = time.time() - t0
    ms = [r["ms"] for r in results]
    n_sat = sum(bool(r.get("saturated")) for r in results)
    n_box = sum(len(r["detections"]) for r in results)
    n_err = sum("error" in r for r in results)
    if len(ms) > 1:
        print(f"wall          {wall:.2f}s  first={ms[0]:.0f} ms "
              f"(build), steady={np.mean(ms[1:]):.0f} ms")
    else:
        print(f"wall          {wall:.2f}s")
    print(f"boxes         {n_box} total, {n_sat} frames top-k saturated")
    s = service.stats
    print(f"service stats frames={s['frames']} "
          f"batches={s['frame_batches']} "
          f"occupancy={s['frame_occupancy']:.2f}")
    lat = s["latency_ms"]
    print(f"resilience    p50={lat['p50']:.0f}ms p99={lat['p99']:.0f}ms "
          f"shed={s['deadline_shed']} retries={s['retries']} "
          f"restarts={s['restarts']} "
          f"breaker={s['breaker']['state']} rung={s['degraded_mode']}")
    plat = s["platform"]
    print(f"platform      {service.device.type} x{plat['device_count']} "
          f"({plat['device_kind'] or 'no GPU'}) "
          f"torch={plat['torch_version']} cuda={plat['cuda_version']}")
    service.stop()
    if args.metrics:
        from ..obs import JsonlSink
        events = JsonlSink.read(args.metrics)
        by_kind = {}
        for e in events:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        kinds = " ".join(f"{k}={n}" for k, n in sorted(by_kind.items()))
        print(f"metrics       {len(events)} events: {kinds}")
    if args.chaos:
        # liveness gate: every future resolved, chaos or not
        resolved = s["frame_answers"] == len(frames)
        print(f"chaos         fired={opts['faults'].fired} "
              f"errors={n_err} all_resolved={resolved}")
        return 0 if resolved else 1
    return 0


def main(argv=None):
    from ..configs import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM serving smoke: arch id (see repro_torch."
                         "configs; the dense family runs)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--detect", action="store_true",
                    help="detection-service smoke over repro_torch.api "
                         "(DetectionSession.serve)")
    ap.add_argument("--frames", type=int, default=6,
                    help="frames to stream in --detect mode")
    ap.add_argument("--preset", default=None,
                    help="PipelineConfig preset for --detect")
    ap.add_argument("--chaos", action="store_true",
                    help="--detect: run under the standard fault-"
                         "injection schedule (worker kill, device "
                         "loss, latency spikes) and gate on liveness")
    ap.add_argument("--load", metavar="DIR", default=None,
                    help="--detect: restore SVM params from a "
                         "checkpoint dir instead of training")
    ap.add_argument("--metrics", metavar="PATH", default=None,
                    help="--detect: stream service telemetry as JSONL "
                         "events to PATH (DESIGN.md §15 schema)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where everything runs (default: the GPU; "
                         "without one, only cpu runs)")
    args = ap.parse_args(argv)

    if args.detect:
        return _detect_smoke(args)

    import torch

    from ..configs import get_config
    from ..core.detector import resolve_device
    from ..models.model import init_params
    from ..serve.engine import generate

    if args.arch not in ARCH_IDS:
        ap.error(f"--arch is required unless --detect "
                 f"(choices: {', '.join(ARCH_IDS)})")

    cfg = get_config(args.arch, smoke=True)
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    t0 = time.time()
    out = generate(params, cfg, prompt, max_new_tokens=args.new_tokens,
                   temperature=args.temperature,
                   generator=torch.Generator(dev).manual_seed(2))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"arch={cfg.name}  out={tuple(out.shape)}  "
          f"{args.batch*args.new_tokens/dt:,.0f} tok/s (incl. first "
          f"launches)")
    print("sample:", out[0, args.prompt_len:args.prompt_len+16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
