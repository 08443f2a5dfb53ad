#!/usr/bin/env python3
"""Where an LM prefill and decode step spend the card's time, by kernel.

    python3 tools/lm_profile.py [--arch A,B] [--batch 4] [--prompt-len 512]
        [--top 6]

For each arch (default olmoe-1b-7b, mamba2-130m, hymba-1.5b,
whisper-large-v3, qwen2-vl-72b) at full width in bf16 with seeded random
weights made on the card, runs one prefill of B x S seeded tokens and one
decode step after it under torch.profiler and prints the card, then one
JSON line per arch and phase: device busy ms, launches, and the ``--top``
kernels by device time (name cut to 60 characters, ms, launches, share
of the busy time). As chip_smoke.py runs them: whisper-large-v3 encodes
1,500 seeded frame embeddings and takes a prompt of at most 224 tokens
(its longest); qwen2-vl-72b keeps 8 of its 80 layers and profiles a
prefill of each prompt group ("text", "image": chip_smoke.vlm_positions)
and a decode step after the image one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("olmoe-1b-7b", "mamba2-130m", "hymba-1.5b", "whisper-large-v3",
         "qwen2-vl-72b")


def profile(torch, fn) -> dict:
    """{kernel name: (launches, device ms)} of one call of ``fn`` after a
    warm-up call."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = (e.count, float(us) / 1e3)
    return out


def summary(arch: str, phase: str, times: dict, top: int) -> dict:
    busy = sum(ms for _, ms in times.values())
    ranked = sorted(times.items(), key=lambda kv: -kv[1][1])[:top]
    return {"arch": arch, "phase": phase, "busy_ms": round(busy, 4),
            "launches": sum(n for n, _ in times.values()),
            "top": [[k[:60], round(ms, 4), n, round(ms / busy, 3)]
                    for k, (n, ms) in ranked]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=",".join(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import dataclasses

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lm_profile: no GPU", file=sys.stderr)
        return 2
    from chip_smoke import (LM_ENCDEC_BATCH, LM_VLM_LAYERS, LM_VLM_GROUPS,
                            vlm_positions)
    from repro_torch.configs import get_config
    from repro_torch.models.model import (decode_step, encode, init_params,
                                          prefill)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for arch in args.arch.split(","):
        B, S = args.batch, args.prompt_len
        cfg = get_config(arch)
        if cfg.mrope:
            cfg = dataclasses.replace(cfg, n_layers=LM_VLM_LAYERS)
        if cfg.encoder_layers:
            S = min(S, LM_ENCDEC_BATCH[2])
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        rng = np.random.default_rng(2)
        x = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device="cuda")
        # (phase name, the batch's other entries) per prefill profiled
        batches = [("prefill", {})]
        enc = None
        if cfg.encoder_layers:
            frames = torch.as_tensor(rng.standard_normal(
                (B, cfg.encoder_ctx, cfg.d_model), dtype=np.float32),
                device="cuda")
            batches = [("prefill", {"enc_input": frames})]
            enc = encode(params, frames, cfg)
        if cfg.mrope:
            batches = [(f"prefill {g}", {"positions": vlm_positions(
                np, g, B, S)}) for g, _, _ in LM_VLM_GROUPS]
        for phase, extra in batches:
            print(json.dumps(summary(arch, phase, profile(
                torch, lambda: prefill(params, {"tokens": x, **extra}, cfg,
                                       S + 1)), args.top)), flush=True)
        _, cache = prefill(params, {"tokens": x, **extra}, cfg, S + 1)
        print(json.dumps(summary(arch, "decode", profile(
            torch, lambda: decode_step(params, x[:, -1:], cache, cfg,
                                       enc=enc)), args.top)), flush=True)
        del params, cache, enc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
