#!/usr/bin/env python3
"""Device time of the window kernels on one GPU.

    python3 tools/window_kernels.py [--src DIR] [--tag NAME] [--sweep]
                                    [--only K1,K2,...]

Every window kernel in every mode on seeded 130x66 windows at B = 11, 64
(the service's window_batch), 512 (the timing bench's chunk) and 5,949
(one 640x480 frame's windows), through the public wrappers, so the launch
plan is the one each wrapper picks: hog_gradient and fused_hog (sector,
cordic, fixed; the fixed mode on integer-valued gray), cell_hist (f32
from sector magnitudes, int16 from fixed ones), block_norm (rsqrt and nr
on the f32 histograms, fixed on the int16 ones) and svm_scores (f32 and
bf16 rows of sector descriptors, the golden weights). Device
microseconds per call from torch.profiler (the kernel's own time, launch
gaps excluded), the mean of 20 calls.

--src: the directory holding the repro_torch package (default: this
checkout's src/); point it at another checkout's src/ to time that tree
in the same call. --sweep (this checkout only): also every compiled band
of each kernel that has a choice of them (kernels/hog_gradient.py:
GRADIENT_BANDS, kernels/fused_hog.py:WINDOW_BANDS,
kernels/block_norm.py:BLOCK_NORM_BANDS) at every B, through the modules'
launch helpers, so the plans' rule can be read against the card. --only:
the kernels to time (default: all five).

Prints the card (nvidia-smi name and power limit), then one JSON object
per line: {"tag", "kernel", "mode", "B", "plan" (a swept band; null:
the wrapper's plan), "same" (a swept band's output equal to
the wrapper's, bit for bit; for block_norm the wrapper's output equal to
dense_block_norm's, bit for bit), "device_us"}. Without a GPU it exits 2
and prints no result.
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
KERNELS = ("hog_gradient", "fused_hog", "cell_hist", "block_norm",
           "svm_scores")


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
    ap.add_argument("--only", default=",".join(KERNELS))
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(KERNELS):
        ap.error(f"--only takes some of {','.join(KERNELS)}")
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("window_kernels: no GPU", file=sys.stderr)
        return 2
    import repro_torch.kernels.block_norm as bn
    import repro_torch.kernels.cell_hist as chist
    import repro_torch.kernels.dense_block_norm as dbn
    import repro_torch.kernels.fused_hog as fh
    import repro_torch.kernels.hog_gradient as hg
    import repro_torch.kernels.svm_matmul as sm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    rng = np.random.default_rng(5)
    g = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")
    w = torch.from_numpy(g["svm_w"]).cuda()
    bias = torch.from_numpy(np.asarray(g["svm_b"], np.float32)).cuda()

    def emit(kernel, mode, B, plan, us, same=None):
        print(json.dumps({"tag": args.tag, "kernel": kernel, "mode": mode,
                          "B": B, "plan": plan, "same": same,
                          "device_us": None if us is None
                          else round(us, 3)}), flush=True)

    def timed(kernel, mode, B, fn, same=None):
        if kernel in only:
            emit(kernel, mode, B, None,
                 device_us(torch, fn, f"{kernel}_kernel"), same)

    for B in SIZES:
        shape = (B, 130, 66)
        grays = {"float": torch.from_numpy(
            rng.uniform(0, 255, shape).astype(np.float32)).cuda(),
                 "fixed": torch.from_numpy(
            rng.integers(0, 256, shape).astype(np.float32)).cuda()}
        hists = {}
        for mode in MODES:
            gray = grays["fixed" if mode == "fixed" else "float"]
            timed("hog_gradient", mode, B,
                  lambda: hg.hog_gradient(gray, mode))
            timed("fused_hog", mode, B, lambda: fh.fused_hog(gray, mode=mode))
            if mode != "cordic":
                mag, bins = hg.hog_gradient(gray, mode)
                hists[mode] = chist.cell_hist(mag, bins)
                dt = "int16" if mode == "fixed" else "f32"
                timed("cell_hist", dt, B,
                      lambda: chist.cell_hist(mag, bins))
            if not args.sweep:
                continue
            if "hog_gradient" in only:
                want = hg.hog_gradient(gray, mode)
                for r in hg.GRADIENT_BANDS:
                    plan = hg.gradient_plan_at(r, B, 130)
                    got = hg._launch(gray, mode, plan)
                    emit("hog_gradient", mode, B, r, device_us(
                        torch, lambda: hg._launch(gray, mode, plan),
                        "hog_gradient_kernel"),
                        all(map(torch.equal, got, want)))
            if "fused_hog" in only:
                want = fh.fused_hog(gray, mode=mode)
                for k in fh.WINDOW_BANDS:
                    plan = fh.window_plan_at(k, B, 130)
                    got = fh._window_launch(gray, 1e-2, mode, plan)
                    emit("fused_hog", mode, B, k, device_us(
                        torch, lambda: fh._window_launch(gray, 1e-2, mode,
                                                         plan),
                        "fused_hog_kernel"), torch.equal(got, want))

        for norm, hist in (("rsqrt", hists["sector"]), ("nr", hists["sector"]),
                           ("fixed", hists["fixed"])):
            if "block_norm" not in only:
                break
            want = bn.block_norm(hist, mode=norm)
            same = torch.equal(want, dbn.dense_block_norm(hist, mode=norm))
            timed("block_norm", norm, B,
                  lambda: bn.block_norm(hist, mode=norm), same)
            for k in bn.BLOCK_NORM_BANDS if args.sweep else ():
                plan = bn.block_norm_plan_at(k, B, 16)
                got = bn._launch(hist, 1e-2, norm, plan)
                emit("block_norm", norm, B, k, device_us(
                    torch, lambda: bn._launch(hist, 1e-2, norm, plan),
                    "block_norm_kernel"), torch.equal(got, want))

        desc = fh.fused_hog(grays["float"], mode="sector")
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            if "svm_scores" not in only:
                break
            feats = desc.to(dt).contiguous()
            timed("svm_scores", name, B,
                  lambda: sm.svm_scores(feats, w, bias))
    return 0


if __name__ == "__main__":
    sys.exit(main())
