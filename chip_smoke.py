#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

  1. card identity (nvidia-smi name and power limit);
  2. build every CUDA kernel from csrc/ (one nvcc per source, in
     parallel) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes (all three pyramid levels of 640x480 and
     1280x720) plus a ragged shape, in every mode, and time kernel,
     plain version and, where one exists, the library call;
  4. drive the main path -- DetectionSession.detect on the card for the
     paper preset with the "kernel" backend and for the perf preset, on
     seeded synthetic 640x480 and 1280x720 frames -- with every launch
     counter reset just before each configuration's run and read just
     after it, so each path shows its own kernels; hold the kept boxes
     and scores against the same session on the CPU; time ms/frame and
     the per-frame split between kernels, resize matmuls, the 105-add
     collate and the top-k + NMS loop;
  5. print the kernels line (JSON) and, last, the ok line (JSON).

It imports no JAX and nothing of the reference package. Without a GPU,
or run outside a checkout of the repository, it fails and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core FLOP/s
# and dense bf16 tensor-core FLOP/s; a bound is the larger of bytes over
# the memory rate and operations over the peak for their type
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

# operations per pixel of the gradient + mag/bin + histogram chain:
# 2 differences, 3 for the squared norm, 1 sqrt, then sector: 8 x (2 mul,
# 1 sub, 1 compare, 1 add); cordic: 15 x (compare, 4 mul, 3 add) + fold,
# mod, divide, floor, clamp; both end in 9 selects + 9 adds
PIXEL_OPS = {"sector": 2 + 3 + 1 + 40 + 18, "cordic": 2 + 3 + 1 + 120 + 8 + 18}
# operations per block of the normalize tail: 36 mul + 36 add + eps add,
# sqrt + divide (rsqrt) or the seed and 2 x 5 NR ops (nr), 36 mul
BLOCK_OPS = {"rsqrt": 36 + 36 + 1 + 2 + 36, "nr": 36 + 36 + 1 + 11 + 36}

FRAME_SIZES = ((480, 640), (720, 1280))      # (H, W), as BENCH_detect.json
RAGGED = (2, 117, 165)                       # 14x20 cells: 13x19 blocks
THRESHOLD = 0.26     # keeps 19-74 boxes per frame with the golden weights
SCORE_TOL = {"f32": 1e-4, "bf16": 2e-3}      # card vs CPU session scores
HIST_RTOL, HIST_ATOL = 1e-5, 1e-4            # summation order only
BLOCK_ATOL = 5e-5
MATMUL_ATOL = {"f32": 1e-5, "bf16": 1e-4}

# the kernels each main-path configuration must launch, and no others
PATH_KERNELS = {
    "paper+kernel": ("dense_grad_hist", "dense_block_norm", "score_matmul"),
    "perf": ("dense_fused_hog", "score_matmul"),
}

KERNELS = {
    "dense_grad_hist": ("src/repro_torch/csrc/dense_grad_hist.cu",
                        "src/repro/kernels/dense_grad_hist.py:62"),
    "dense_block_norm": ("src/repro_torch/csrc/dense_block_norm.cu",
                         "src/repro/kernels/dense_block_norm.py:41"),
    "dense_fused_hog": ("src/repro_torch/csrc/dense_fused_hog.cu",
                        "src/repro/kernels/fused_hog.py:137"),
    "score_matmul": ("src/repro_torch/csrc/score_matmul.cu",
                     "src/repro/kernels/svm_matmul.py:80"),
}


class SmokeFailure(Exception):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``reps`` back-to-back
    calls, between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def level_shapes(h: int, w: int, bucket: int = 32):
    """(gh+2, gw+2) trimmed gray shape of each pyramid level of an
    (h, w) frame, as core/detector.py and core/stages.py derive them."""
    ph, pw = -(-h // bucket) * bucket, -(-w // bucket) * bucket
    out = []
    for s in (1.0, 0.8, 0.64):
        sh, sw = int(ph * s), int(pw * s)
        out.append(((sh - 2) // 8 * 8 + 2, (sw - 2) // 8 * 8 + 2))
    return out


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def device_times(torch, fn, reps: int):
    """Run ``fn`` ``reps`` times under torch.profiler; returns {kernel
    name: (launches, device microseconds)} of the CUDA kernels it ran."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = (e.count, float(us))
    return out


def kernel_device_ms(torch, fn, symbol: str, reps: int = 20):
    """Device milliseconds per call of ``fn`` spent in kernels whose name
    contains ``symbol`` (torch.profiler; launch gaps excluded), or None
    when the profiler saw no such kernel."""
    times = device_times(torch, fn, reps)
    us = sum(t for k, (_, t) in times.items() if symbol in k)
    return us / 1e3 / reps if us > 0 else None


def frame_profile(torch, sess, frame, reps: int = 3) -> dict:
    """Kernel launches and device-busy milliseconds per frame of one
    session, from torch.profiler; the rest of the frame is idle device."""
    times = device_times(
        torch, lambda: sess.detect(frame).block_until_ready(), reps)
    return {"device_launches_per_frame": sum(c for c, _ in times.values())
            / reps,
            "device_busy_ms": sum(t for _, t in times.values()) / 1e3 / reps}


def frame_split(torch, np, sess, h: int, w: int) -> dict:
    """Each stage of one frame's program alone on the card, at the
    frame's shapes (CUDA events over back-to-back repetitions)."""
    import repro_torch.core.detector as det_mod
    import repro_torch.core.stages as stages
    import repro_torch.kernels.svm_matmul as sm
    det = sess.detector
    prog, ph, pw = det.program_for(h, w)
    gray = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 255, (ph, pw)).astype(np.float32)).cuda()
    levels = prog.pyramid(gray)
    hcfg = det.cfg.hog
    bh, bw = hcfg.blocks_hw
    blocks = [stages.dense_blocks(g, hcfg, det.cfg.backend) for g in levels]
    contribs = [torch.zeros(b.shape[:2] + (bh * bw,), device="cuda")
                for b in blocks]
    boxes = torch.from_numpy(prog.boxes).cuda()
    scores = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, len(prog.boxes)).astype(np.float32)).cuda()

    def resize():
        prog.pyramid(gray)

    def hog():
        for g in levels:
            stages.dense_blocks(g, hcfg, det.cfg.backend)

    def score_matmul():
        wt = det.svm["w"].reshape(105, 36).T.contiguous()
        for b in blocks:
            sm.score_matmul(b.reshape(-1, 36), wt)

    def collate():
        for c in contribs:
            det_mod.collate_scores(c, bh, bw)

    def topk_nms():
        top, idx = det_mod.top_k(scores, prog.k)
        det_mod.nms_keep(boxes[idx], top, det.cfg.nms_iou)

    return {"resize_ms": cuda_ms(resize, reps=10),
            "hog_ms": cuda_ms(hog, reps=10),
            "score_matmul_ms": cuda_ms(score_matmul, reps=10),
            "collate_ms": cuda_ms(collate, reps=5),
            "topk_nms_ms": cuda_ms(topk_nms, reps=3)}


# ------------------------------------------------------------- phase 3

def check_kernels(torch, np) -> dict:
    import repro_torch.kernels.dense_block_norm as dbn
    import repro_torch.kernels.dense_grad_hist as dgh
    import repro_torch.kernels.fused_hog as fh
    import repro_torch.kernels.svm_matmul as sm

    gw = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")["svm_w"]
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    shapes = [("640x480", (1,) + s) for s in level_shapes(480, 640)]
    shapes += [("1280x720", (1,) + s) for s in level_shapes(720, 1280)]
    shapes += [("ragged", RAGGED)]
    err = {k: 0.0 for k in KERNELS}
    rows = []

    def record(kernel, where, shape, mode, e, fn, plain_fn, lib_ms, nbytes,
               ops, peak, symbol):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain_fn, reps=5)
        bound = max(nbytes / HBM_BPS, ops / peak) * 1e3
        row = {"kernel": kernel, "frame": where, "shape": list(shape),
               "mode": mode, "max_abs_err": e, "ms": ms,
               "device_ms": kernel_device_ms(torch, fn, symbol),
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound,
               "bound_by": "bytes" if nbytes / HBM_BPS >= ops / peak
               else "operations"}
        rows.append(row)
        err[kernel] = max(err[kernel], e)
        print(f"  {kernel:16s} {where:8s} {str(tuple(shape)):18s} "
              f"{mode:6s} err {e:.3e}  kernel {ms:.4f} ms (device "
              f"{_fmt(row['device_ms'])})  plain "
              f"{plain_ms:.4f} ms  library "
              f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}  "
              f"bound {bound:.5f} ms ({row['bound_by']})", flush=True)

    for where, shape in shapes:
        B, H, W = shape
        gray = torch.from_numpy(
            rng.uniform(0, 255, shape).astype(np.float32)).to(dev)
        ch, cw = (H - 2) // 8, (W - 2) // 8
        pixels = B * ch * 8 * cw * 8
        nblocks = B * (ch - 1) * (cw - 1)
        for mode in ("sector", "cordic"):
            got = dgh.dense_grad_hist(gray, mode=mode)
            want = dgh.dense_grad_hist_plain(gray, mode=mode)
            torch.cuda.synchronize()
            need(got.shape == want.shape, f"dense_grad_hist shape {shape}")
            e = float((got - want).abs().max())
            ok = bool(((got - want).abs()
                       <= HIST_ATOL + HIST_RTOL * want.abs()).all())
            need(ok, f"dense_grad_hist {mode} {shape}: max err {e}")
            record("dense_grad_hist", where, shape, mode, e,
                   lambda: dgh.dense_grad_hist(gray, mode=mode),
                   lambda: dgh.dense_grad_hist_plain(gray, mode=mode), None,
                   4 * gray.numel() + 4 * want.numel(),
                   pixels * PIXEL_OPS[mode], F32_FLOPS,
                   "dense_grad_hist_kernel")

            hist = want
            norm = "nr" if mode == "cordic" else "rsqrt"
            got = dbn.dense_block_norm(hist, mode=norm)
            wantb = dbn.dense_block_norm_plain(hist, mode=norm)
            torch.cuda.synchronize()
            e = float((got - wantb).abs().max())
            need(e <= BLOCK_ATOL, f"dense_block_norm {norm} {shape}: {e}")
            record("dense_block_norm", where, shape, norm, e,
                   lambda: dbn.dense_block_norm(hist, mode=norm),
                   lambda: dbn.dense_block_norm_plain(hist, mode=norm), None,
                   4 * hist.numel() + 4 * wantb.numel(),
                   nblocks * BLOCK_OPS[norm], F32_FLOPS,
                   "dense_block_norm_kernel")

            got = fh.dense_fused_hog(gray, mode=mode)
            want = fh.dense_fused_hog_plain(gray, mode=mode)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            need(e <= BLOCK_ATOL, f"dense_fused_hog {mode} {shape}: {e}")
            record("dense_fused_hog", where, shape, mode, e,
                   lambda: fh.dense_fused_hog(gray, mode=mode),
                   lambda: fh.dense_fused_hog_plain(gray, mode=mode), None,
                   4 * gray.numel() + 4 * want.numel(),
                   pixels * PIXEL_OPS[mode] + nblocks * BLOCK_OPS[norm],
                   F32_FLOPS, "dense_fused_hog_kernel")

        blocks = want.reshape(-1, 36)
        for dname, dt, peak in (("f32", torch.float32, F32_FLOPS),
                                ("bf16", torch.bfloat16, BF16_FLOPS)):
            flat = blocks.to(dt).contiguous()
            wt = torch.from_numpy(gw).to(dev).reshape(105, 36).T.to(dt) \
                .contiguous()
            got = sm.score_matmul(flat, wt)
            wantm = sm.score_matmul_plain(flat, wt)
            torch.cuda.synchronize()
            e = float((got - wantm).abs().max())
            need(e <= MATMUL_ATOL[dname], f"score_matmul {dname} {shape}: {e}")
            if dt == torch.float32:
                lib = cuda_ms(lambda: torch.matmul(flat, wt))
            else:
                try:     # one call with f32 output, where torch has it
                    torch.mm(flat, wt, out_dtype=torch.float32)
                    lib = cuda_ms(lambda: torch.mm(flat, wt,
                                                   out_dtype=torch.float32))
                except (TypeError, RuntimeError):
                    lib = cuda_ms(lambda: torch.matmul(flat, wt))
                    print("  (bf16 library_ms: torch.matmul, bf16 output)")
            M = flat.shape[0]
            record("score_matmul", where, (M, 36, 105), dname, e,
                   lambda: sm.score_matmul(flat, wt),
                   lambda: sm.score_matmul_plain(flat, wt),
                   lib, flat.element_size() * (M * 36 + 36 * 105)
                   + 4 * M * 105, 2 * M * 36 * 105, peak,
                   "score_matmul_kernel")

    # one entry per kernel: a 640x480 frame's three levels, in the mode
    # the paper preset's "kernel" backend (dense_grad_hist,
    # dense_block_norm, score_matmul f32) and the perf preset
    # (dense_fused_hog) run
    main_mode = {"dense_grad_hist": "sector", "dense_block_norm": "rsqrt",
                 "dense_fused_hog": "sector", "score_matmul": "f32"}
    summary = {}
    for k, m in main_mode.items():
        sel = [r for r in rows if r["kernel"] == k and r["mode"] == m
               and r["frame"] == "640x480"]
        need(len(sel) == 3, f"missing 640x480 timings of {k}")
        lib = [r["library_ms"] for r in sel]
        summary[k] = {
            "ms": sum(r["ms"] for r in sel),
            "device_ms": None if None in [r["device_ms"] for r in sel]
            else sum(r["device_ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": sum(r["bound_ms"] for r in sel),
            "bound_by": sel[0]["bound_by"],
            "library_ms": None if lib[0] is None else sum(lib),
            "max_abs_err": err[k]}
    return summary


# ------------------------------------------------------------- phase 4

def main_path(torch, np) -> dict:
    import repro_torch.api as api
    import repro_torch.data.synth_pedestrian as synth
    import repro_torch.kernels as kernels

    g = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")
    svm = {"w": g["svm_w"], "b": g["svm_b"]}
    paper = api.presets("paper")
    perf = api.presets("perf")
    configs = {
        "paper+kernel": (paper.replace(detector=dataclasses.replace(
            paper.detector, backend="kernel", score_threshold=THRESHOLD)),
            "f32"),
        "perf": (perf.replace(detector=dataclasses.replace(
            perf.detector, score_threshold=THRESHOLD)), "bf16"),
    }
    frames = {(h, w): [synth.make_scene(np.random.default_rng(seed), h, w,
                                  n_people=3)[0] for seed in (0, 1)]
              for h, w in FRAME_SIZES}
    gpu = {n: api.DetectionSession(svm, c, device="cuda")
           for n, (c, _) in configs.items()}
    cpu = {n: api.DetectionSession(svm, c, device="cpu")
           for n, (c, _) in configs.items()}

    results, launches = {}, {}
    for name, sess in gpu.items():
        kernels.reset_launches()
        for hw, fs in frames.items():
            results[(name, hw)] = [sess.detect(f).block_until_ready()
                                   for f in fs]
        torch.cuda.synchronize()
        launches[name] = counts = kernels.launch_counts()
        print(f"main path {name} launches: {counts}", flush=True)
        for k, n in counts.items():
            if k in PATH_KERNELS[name]:
                need(n > 0, f"kernel {k} was not launched on the {name} path")
            else:
                need(n == 0, f"kernel {k} launched {n} times on the {name} "
                             f"path, which should not run it")

    per_frame = {}
    for (name, hw), dets in results.items():
        dt = configs[name][1]
        for i, (d, f) in enumerate(zip(dets, frames[hw])):
            ref = cpu[name].detect(f).to_list()
            got = d.to_list()
            need(len(got) >= 3, f"{name} {hw} frame {i}: only {len(got)} "
                                f"boxes kept; the comparison is vacuous")
            need([x["box"] for x in got] == [x["box"] for x in ref],
                 f"{name} {hw} frame {i}: kept boxes differ from the CPU "
                 f"session ({len(got)} vs {len(ref)})")
            de = max(abs(a["score"] - b["score"]) for a, b in zip(got, ref))
            need(de <= SCORE_TOL[dt], f"{name} {hw} frame {i}: score "
                                      f"delta {de} > {SCORE_TOL[dt]}")
            print(f"  {name:12s} {hw[1]}x{hw[0]} frame {i}: {len(got)} "
                  f"boxes kept, same as CPU, max score delta {de:.2e}",
                  flush=True)
        sess = gpu[name]

        def run():
            for f in frames[hw]:
                sess.detect(f).block_until_ready()
        run()
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            run()
        ms = (time.perf_counter() - t0) * 1e3 / (reps * len(frames[hw]))
        per_frame[f"{name} {hw[1]}x{hw[0]}"] = ms
        print(f"  {name:12s} {hw[1]}x{hw[0]}: {ms:.3f} ms/frame "
              f"(detect + synchronize, host clock)", flush=True)

    for h, w in FRAME_SIZES:
        key = f"{w}x{h}"
        split = frame_split(torch, np, gpu["paper+kernel"], h, w)
        split.update(frame_profile(torch, gpu["paper+kernel"],
                                   frames[(h, w)][0]))
        split["ms_per_frame"] = per_frame[f"paper+kernel {key}"]
        print(f"  split {key} (paper+kernel): "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()),
              flush=True)
    return launches


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: FAIL: src/repro_torch not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        need(bool(card), "nvidia-smi printed no card")
        print(card[0], flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}", flush=True)

        import repro_torch.kernels.build as build
        t0 = time.perf_counter()
        took = build.build_all()
        print(f"build: {time.perf_counter() - t0:.1f} s for "
              f"{len(took)} kernels in parallel "
              f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})",
              flush=True)
        for name in build.SOURCES:
            log = build.library_path(name).with_suffix(".log")
            for line in (log.read_text().splitlines() if log.exists()
                         else []):
                if "registers" in line or ("spill" in line and
                                           "0 bytes spill stores, 0 bytes "
                                           "spill loads" not in line):
                    print(f"  ptxas {name}: {line.strip()}")

        print("kernel checks (card vs plain version on the card):",
              flush=True)
        summary = check_kernels(torch, np)
        print("main path:", flush=True)
        launches = main_path(torch, np)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1

    # launches: the sum of each path's own count (each read right after
    # that path's run), with the per-path counts beside it
    kernels_line = {"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1],
         "launches": sum(c[k] for c in launches.values()),
         "launches_by_path": {p: c[k] for p, c in launches.items()
                              if k in PATH_KERNELS[p]},
         **summary[k]} for k in KERNELS]}
    print(json.dumps(kernels_line))
    print(card[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
