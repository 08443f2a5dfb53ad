#!/usr/bin/env python3
"""Device time of the window kernels hog_gradient and fused_hog on one GPU.

    python3 tools/window_kernels.py [--src DIR] [--tag NAME] [--sweep]

Each kernel in every mode (sector, cordic, fixed; the fixed mode on
integer-valued gray) on seeded 130x66 windows at B = 11, 64 (the
service's window_batch), 512 (the timing bench's chunk) and 5,949 (one
640x480 frame's windows), through the public wrappers, so the launch
plan is the one each wrapper picks. Device microseconds per call from
torch.profiler (the kernel's own time, launch gaps excluded), the mean of
20 calls.

--src: the directory holding the repro_torch package (default: this
checkout's src/); point it at another checkout's src/ to time that tree
in the same call. --sweep (this checkout only): also every band each
kernel is compiled for (kernels/hog_gradient.py:GRADIENT_BANDS,
kernels/fused_hog.py:WINDOW_BANDS) at every B, through the modules'
launch helpers, so the plans' rule can be read against the card.

Prints the card (nvidia-smi name and power limit), then one JSON object
per line: {"tag", "kernel", "mode", "B", "band" (null: the wrapper's
plan), "same" (a swept band's output equal to the wrapper's, bit for
bit), "device_us"}. Without a GPU it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZES = (11, 64, 512, 5949)
MODES = ("sector", "cordic", "fixed")


def device_us(torch, fn, symbol: str, reps: int = 20):
    """Device microseconds per call of ``fn`` in kernels whose name holds
    ``symbol`` (torch.profiler), or None when it saw none in two tries."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if symbol in e.key and str(getattr(e, "device_type",
                                               "")).endswith("CUDA"):
                t = getattr(e, "self_device_time_total", None)
                us += float(e.self_cuda_time_total if t is None else t)
        if us > 0:
            return us / reps
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("window_kernels: no GPU", file=sys.stderr)
        return 2
    import repro_torch.kernels.fused_hog as fh
    import repro_torch.kernels.hog_gradient as hg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    rng = np.random.default_rng(5)

    def emit(kernel, mode, B, band, us, same=None):
        print(json.dumps({"tag": args.tag, "kernel": kernel, "mode": mode,
                          "B": B, "band": band, "same": same,
                          "device_us": None if us is None
                          else round(us, 3)}), flush=True)

    for B in SIZES:
        shape = (B, 130, 66)
        grays = {"float": torch.from_numpy(
            rng.uniform(0, 255, shape).astype(np.float32)).cuda(),
                 "fixed": torch.from_numpy(
            rng.integers(0, 256, shape).astype(np.float32)).cuda()}
        for mode in MODES:
            gray = grays["fixed" if mode == "fixed" else "float"]
            emit("hog_gradient", mode, B, None, device_us(
                torch, lambda: hg.hog_gradient(gray, mode),
                "hog_gradient_kernel"))
            emit("fused_hog", mode, B, None, device_us(
                torch, lambda: fh.fused_hog(gray, mode=mode),
                "fused_hog_kernel"))
            if not args.sweep:
                continue
            want_g = hg.hog_gradient(gray, mode)
            want_f = fh.fused_hog(gray, mode=mode)
            for r in hg.GRADIENT_BANDS:
                plan = hg.gradient_plan_at(r, B, 130)
                got = hg._launch(gray, mode, plan)
                emit("hog_gradient", mode, B, r, device_us(
                    torch, lambda: hg._launch(gray, mode, plan),
                    "hog_gradient_kernel"), all(map(torch.equal, got, want_g)))
            for k in fh.WINDOW_BANDS:
                plan = fh.window_plan_at(k, B, 130)
                got = fh._window_launch(gray, 1e-2, mode, plan)
                emit("fused_hog", mode, B, k, device_us(
                    torch, lambda: fh._window_launch(gray, 1e-2, mode, plan),
                    "fused_hog_kernel"), torch.equal(got, want_f))
    return 0


if __name__ == "__main__":
    sys.exit(main())
