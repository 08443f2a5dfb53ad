#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

  1. card identity (nvidia-smi name and power limit);
  2. build every CUDA kernel from csrc/ (one nvcc per source, in
     parallel) and print the build time, ptxas's registers, fewest and
     most per source (failing on any spill; the spill bytes of
     dense_grad_hist, dense_block_norm, hog_gradient and fused_hog
     printed), and the HGMMA and UTMALDG count of flash_attention_sm90's
     SASS (failing on a zero there);
  3. hold each dense kernel against its plain PyTorch version on the
     card, at the detector's shapes (all three pyramid levels of 640x480
     and 1280x720) plus a ragged shape, in every mode -- the fixed modes
     on integer-valued gray, int16 histograms and int8 scores exact,
     blocks within one int8 code step with rare flips -- and time
     kernel, plain version and, where one exists, the library call (its
     device time, as the kernel's); one line per kernel and mode, under
     the device time of a one-element add_ (one launch's floor);
     dense_block_norm(dense_grad_hist(g)) must equal dense_fused_hog(g)
     bit for bit in every mode at every shape; then the pair level by
     level (each kernel's device time, its launch plan's tile, CTAs and
     resident warps per SM, failing under 132 CTAs on a 640x480 level)
     and dense_fused_hog level by level (device time, tile, CTAs, warps
     per SM, failing under 132 CTAs on a 640x480 level or 16 warps on the
     largest, and recomputed cells); then
     each scorer dtype level by level (device us beside the library
     call's, CTAs, rows of the busiest CTA), and the scorers at the
     plan's and the copies' edges (M = 1, 3, 5, 131, 133, operands at odd
     offsets, K = 35, K = 64 with N = 128): f32 within 1e-5, bf16 1e-4,
     int8 equal;
  3b. the same for each window kernel at B = 64 (the service's
     window_batch), 512 (the timing bench's chunk) and a ragged 11
     windows of 130x66, in every mode: bins, integer magnitudes and
     int16 histograms exact, fixed blocks within one int8 code step;
     fused_hog(g) must equal dense_fused_hog(g).reshape(B, -1) bit for
     bit in every mode at every B, and block_norm(h) equal
     dense_block_norm(h) bit for bit in every flavor at every B; then the
     window plans of hog_gradient and fused_hog per B (band, CTAs,
     recompute; failing under 132 CTAs at B >= 64), every compiled band
     of each held to the same output at B = 11, and per kernel and mode
     the device time at B = 64, 512 and 5,949 with the B = 5,949 bound
     and resident warps per SM; then the same for the tail: the plans of
     block_norm and svm_scores per B (failing under 132 CTAs where the
     batch has a CTA's rows for every SM), every compiled band of
     block_norm equal to dense_block_norm at B = 11, svm_scores giving
     the same rows the same scores at B = 11 and 512 and one row later
     (the other bf16 parity), plans the kernels are not built for
     refused, and cell_hist, block_norm and svm_scores timed as above;
  3d. each dense kernel in every mode on a batch of 8 frames of each
     640x480 level: kernel(stack)[i] must equal kernel(frame i) bit for
     bit, and the batch its plain version within the limits of 3;
  4. drive the dense path -- DetectionSession.detect on the card for the
     paper preset with the "kernel" backend, the perf preset, and the
     quant preset with its "fused" backend and with "kernel", on seeded
     synthetic 640x480 and 1280x720 frames -- with every launch counter
     reset just before each configuration's run and read just after it,
     so each path shows its own kernels; hold the kept boxes and scores
     against the same session on the CPU (counting, for quant, the
     resized gray pixels whose whole level differs from the CPU's); time
     ms/frame, the per-frame split between kernels, resize matmuls, the
     105-add collate and the top-k + NMS loop, and the device's launches
     and busy time per frame;
  4c. drive the batched path -- DetectionSession.detect_batch on the
     card for the same four configurations, on batches of 4 and 8 seeded
     640x480 scenes and one batch of two true sizes sharing the 640x480
     bucket, the batch schedule autotuned (no cache file is read or
     written), counters reset before each configuration and read after
     it; hold the kept boxes against the card's single-frame detect (for
     the mixed batch, of each frame's eager gray, as the batch takes it)
     and the CPU session's detect_batch, scores within the same limits;
     time ms/frame (host clock, configurations in turns), launches and
     device-busy ms per frame and the idle share; count the resized
     pixels unlike each frame's own and the CPU's (the resize sums in
     f64), and what f32 GEMMs of the batch's shape would change;
  4d. stream a seeded make_clip clip (640x480, batches of 4) on the card
     and hold its track ids and boxes against the CPU session's;
  4b. drive the window path -- classify_windows on the card for paper
     with the "kernel" path, perf (fused, bf16), quant with "kernel" and
     quant (fused), counters reset before each and read after it -- on
     the 294 windows of the paper's test split (scores held against the
     CPU) and, for paper + kernel, on all 5,949 window positions of a
     640x480 frame's pyramid in chunks of 512 (scores held against the
     dense score_map of the same level at the same position); time
     windows/s, ms per batch, launches and device-busy share per batch
     at B = 64, 512 and 5,949;
  4e. train: Table I at the paper's split (make_dataset: 4,202 + 2,795
     training and 160 + 134 test windows, 3,780 features) in the fp32
     (PAPER_HOG) and fixed (QUANT) modes -- descriptors on the card's ref
     stages, Pegasos on the card with bench_accuracy.py's schedule
     (4,000 steps, neg_weight 3) -- failing unless each total is >= 0.80
     and |fixed - fp32| <= 1.5 points (that bench's gate); the rows beside
     BENCH_detect.json's CPU rows, extract and train seconds, launches and
     device us per Pegasos step; the same features and schedule trained
     on the CPU (w's relative L2 against the card's, the rows) and the
     test descriptors counted where the card's ref stages differ from the
     CPU's; the test split through classify_windows' kernel and fused
     paths with the card-trained SVM, human equal to predict on the ref
     features beyond a score tolerance scaled from the golden weights';
     then DetectionSession.train (paper, kernel backend, one mining round
     of 4 scenes) on the card and the CPU from one seed -- the same
     number of mined crops, and with one SVM the same crops within one
     code -- save / load with the same boxes, and the detect CLI's
     --save then --load printing the same detections without training;
     counters reset before each path (evaluation, mining, CLI) and read
     after it;
  3c. flash_attention against its plain version on the card (and, causal,
     against the port's _sdpa with the causal mask) at the reference's
     flash-test shapes, a ragged S = 100, one bf16 shape at hd 32, and
     qwen3-14b's prefill shapes (B 4 x S 512, B 1 x S 2048, read through
     the (B, S, H, hd) views prefill passes) in f32 and in bf16 on the
     same inputs; each call must launch the route kernels/flash_attention
     .route names (bf16 at hd 16, 64, 128: the wgmma kernel, sm90; the
     rest: the CUDA-core kernel), each bf16 run is also held to
     flash_bf16_matched (its route's roundings in f32, with its key
     tile); at full width both routes run in bf16 and are timed beside
     scaled_dot_product_attention (timed only, used nowhere);
  5. LM serving of qwen3-14b: at smoke size in f32 (weights through
     lm_params_from_numpy) the card's greedy tokens and logits against
     the CPU port's; at full width and depth in bf16 (seeded random
     weights made on the card) generate for 4 prompts of 512 tokens and
     1 of 2,048 (32 new tokens each) with the launch counters reset just
     before and read just after (flash_attention 40 times per prefill,
     all on the sm90 route, no other kernel), the same tokens on a
     second run, prefill against prefill + decode_step (with two
     planted decode faults beside it), and ms per prefill and per decode step with the device's busy time
     and flash attention's share of it; then the same consistency in f32
     at full width (its prefills on the cuda_core route), where the sound
     decode must land under a tight limit and both planted faults over
     it;
  6. print the kernels line (JSON) and, last, the ok line (JSON).

It imports no JAX and nothing of the reference package. Without a GPU,
or run outside a checkout of the repository, it fails and prints no
result.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core FLOP/s
# (an FMA counted as two), dense bf16 tensor-core FLOP/s and int8
# tensor-core OP/s; a bound is the larger of bytes over the memory rate and
# operations over the peak for their type (each type on its own pipe, so
# the slowest type's time where a kernel mixes them).
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
# The CUDA-core lanes behind those peaks (NVIDIA H100 Tensor Core GPU
# Architecture whitepaper: 132 SMs, each with 128 FP32 and 64 INT32 lanes
# per clock; 67e12 = 2 x 128 x 132 x 1.98 GHz). The HOG kernels and
# svm_scores are built with --fmad=false and spell every product and sum
# alone, so each float operation takes one lane-clock: 33.5e12/s, half
# the FMA peak. Their int32 operations (the fixed chain's shifts, adds and
# selects) run on the INT32 lanes, 16.7e12/s, beside the FP32 lanes, so
# hog_op_s counts each pipe apart.
SMS, BOOST_HZ = 132, 1.98e9
F32_NOFMA_OPS = 128 * SMS * BOOST_HZ
INT32_OPS = 64 * SMS * BOOST_HZ

# operations per pixel of the gradient + mag/bin chain, (int32, f32), each
# on its own lanes: sector: 2 differences, 3 for the squared norm, 1 sqrt,
# 8 x (2 mul, 1 sub, 1 compare) in f32 and the 8 adds of the boundary
# count in int32; cordic, all f32: 2 differences, 3 + 1 as sector, 15 x
# (compare, 4 mul, 3 add), fold, mod, divide, floor, clamp; fixed: in f32
# the 2 differences, the 2 roundings to int and the magnitude's convert,
# multiply and rint; in int32 3 for the fold and Q8 shifts, 15 x (2
# shifts, compare, 3 add/sub), 6 for the pin, fold, floor-mod, divide and
# clamp, 2 for the zero test
PIXEL_OPS = {"sector": (8, 2 + 3 + 1 + 32),
             "cordic": (0, 2 + 3 + 1 + 120 + 8),
             "fixed": (3 + 90 + 6 + 2, 2 + 2 + 3)}
# then a pixel's histogram: 9 selects + 9 adds, in the type of the mode's
# sums (int32 in the fixed mode)
HIST_OPS = 18
# operations per block of the normalize tail: 36 mul + 36 add + eps add,
# sqrt + divide (rsqrt) or the seed and 2 x 5 NR ops (nr, fixed), 36 mul;
# fixed adds the quantize-dequantize: 36 max, scale and select, then 36 x
# (divide, rint, multiply)
BLOCK_OPS = {"rsqrt": 36 + 36 + 1 + 2 + 36, "nr": 36 + 36 + 1 + 11 + 36,
             "fixed": 36 + 36 + 1 + 11 + 36 + 36 + 2 + 3 * 36}

FRAME_SIZES = ((480, 640), (720, 1280))      # (H, W), as BENCH_detect.json
RAGGED = (2, 117, 165)                       # 14x20 cells: 13x19 blocks
THRESHOLD = 0.26     # keeps 19-74 boxes per frame with the golden weights
# card vs CPU session scores: summation order (f32), a bf16 rounding
# (bf16); int8: one code step of one block element moves a window score
# by at most max|w| / 127 = 6.4e-4 with the golden weights, and 2e-3
# allows three (from the f32 sum of squares before the quantizer, or a
# resized gray level on x.5 that rounds the other way on the card)
SCORE_TOL = {"f32": 1e-4, "bf16": 2e-3, "int8": 2e-3}
TIMING_REPS = 5                              # ms/frame: 2 frames x 5 reps
# the batched frame path: batches of 4 and 8 seeded 640x480 scenes, and a
# mixed batch of two true sizes that share the 640x480 bucket
BATCH_SIZES = (4, 8)
MIXED_SIZES = ((480, 640), (470, 630), (480, 640), (470, 630))
BATCH_REPS = 3                               # batch ms: reps per config
KERNEL_BATCH = 8                             # batched kernel checks: B 8
HIST_RTOL, HIST_ATOL = 1e-5, 1e-4            # summation order only
# each HOG mode and the normalize flavor it runs (core/numerics.py SPECS)
MODE_NORMS = {"sector": "rsqrt", "cordic": "nr", "fixed": "fixed"}
BLOCK_ATOL = 5e-5
MATMUL_ATOL = {"f32": 1e-5, "bf16": 1e-4}
# scorer rows where the launch plan has edges: one CTA of one unit, a
# ragged unit, two CTAs, 33 and 34 CTAs of one unit each
SCORER_TAILS = (1, 3, 5, 131, 133)

# window path: kernel checks at the service's window_batch
# (repro/api/config.py:79), the timing bench's chunk
# (benchmarks/bench_timing.py) and a ragged batch; classify_windows timed
# at the same two and at one 640x480 frame's 5,949 window positions
# (BENCH_detect.json results.640x480.n_windows), which the layout check
# runs in chunks of 512
WINDOW_BATCHES = (("B64", 64), ("B512", 512), ("B11", 11))
WINDOW_TIMING_B = (64, 512, 5949)
N_FRAME_WINDOWS = 5949
WINDOW_CHUNK = 512
# window scores, card vs CPU: f32 summation order; bf16: a descriptor
# value on a bf16 rounding boundary; quant: float scoring on the int8
# grid, where one code step of one element moves a score by at most
# max|w| / 127 = 6.4e-4 with the golden weights (three allowed)
WINDOW_SCORE_TOL = {"paper": 1e-4, "perf": 2e-3, "quant": 2e-3}
LAYOUT_TOL = 1e-4          # window vs dense scoring: summation order
SVM_ATOL = 1e-5            # svm_scores vs plain: 3,780-term f32 sums
MAG_RTOL = 1e-6            # float magnitudes: one ulp

# flash attention: the reference's flash tests' shapes (B 2, K 2, S 64,
# hd 16, rep 1 and 4, causal or not, f32 and bf16) and ragged S = 100,
# checked only; qwen3-14b's prefill shapes in the (B, S, H, hd) layout
# prefill hands the kernel, checked in f32 and bf16 and timed in bf16;
# tolerances against the plain version are the reference's flash tests'
# (f32 summation order; bf16: the plain version rounds scores and
# weights to bf16, the kernel keeps f32 scores)
FLASH_SMALL = [(2, 2 * rep, 2, 64, 16, causal, dt) for rep in (1, 4)
               for causal in (True, False) for dt in ("f32", "bf16")]
FLASH_SMALL += [(2, 8, 2, 100, 16, causal, dt) for causal in (True, False)
                for dt in ("f32", "bf16")]
# one bf16 shape at an hd outside the sm90 route's (16, 64, 128), so the
# CUDA-core route stays checked in bf16
FLASH_OTHER_HD = [(2, 8, 2, 100, 32, True, "bf16")]
FLASH_TOL = {"f32": 1e-5, "bf16": 3e-2}
# bf16 kernel vs flash_bf16_matched (the same roundings in f32): (atol,
# rtol); the output's own rounding is 2^-9 relative, and f32 summation
# order can flip a rare p by one bf16 ulp
FLASH_MATCHED_TOL = (2e-3, 2.0 ** -7)
LM_ARCH = "qwen3-14b"
# (group, B, prompt length); each prompt gets LM_NEW new tokens
LM_BATCHES = (("B4xS512", 4, 512), ("B1xS2048", 1, 2048))
LM_NEW = 32
# prefill(prompt) vs prefill(prompt[:, :-1]) + decode_step at full width
# in bf16: relative L2 error of the last logits. The two paths round
# other bf16 intermediates (f32 flash scores against _sdpa's bf16
# scores; M = 1 against M = 2,048 matmuls) and 40 residual layers
# compound them; the CPU twin (tests/test_torch_lm.py, 40 layers at
# width 512) holds the same bound
CONSIST_TOL = 5e-2
# the same in f32, where the two paths differ by summation order only
# (1.1e-6 on the CPU twin, planted decode faults 5.5e-2 and more)
CONSIST_TOL_F32 = 1e-3
LM_SMOKE_TOL = 1e-4      # card vs CPU at smoke size, f32 logits
# Table I (benchmarks/bench_accuracy.py): the schedule it trains with,
# and its gate: every mode's total accuracy, and |fixed - fp32| in points
TABLE1_TRAIN = {"steps": 4000, "neg_weight": 3.0}
TABLE1_MIN_TOTAL, TABLE1_MAX_GAP_PTS = 0.80, 1.5
PEGASOS_PROFILE_STEPS = 20     # launches per step: a profiled 20 steps
MINE_SCENES = 4

# the kernels each main-path configuration must launch, and no others
PATH_KERNELS = {
    "paper+kernel": ("dense_grad_hist", "dense_block_norm", "score_matmul"),
    "perf": ("dense_fused_hog", "score_matmul"),
    "quant": ("dense_fused_hog", "score_matmul_int8"),
    "quant+kernel": ("dense_grad_hist", "dense_block_norm",
                     "score_matmul_int8"),
    "window paper+kernel": ("hog_gradient", "cell_hist", "block_norm",
                            "svm_scores"),
    "window perf": ("fused_hog", "svm_scores"),
    "window quant+kernel": ("hog_gradient", "cell_hist", "block_norm",
                            "svm_scores"),
    "window quant": ("fused_hog", "svm_scores"),
    "lm qwen3-14b": ("flash_attention",),
}
# the batched path and the tracked clip run the dense kernels of their
# configuration
DENSE_CONFIGS = ("paper+kernel", "perf", "quant", "quant+kernel")
PATH_KERNELS.update({f"batch {c}": PATH_KERNELS[c] for c in DENSE_CONFIGS})
PATH_KERNELS["stream paper+kernel"] = PATH_KERNELS["paper+kernel"]
# the train phase: the test split through the window kernels with the
# card-trained SVM, per Table I mode; mining and the detect CLI on the
# dense "kernel" backend
TRAIN_EVAL = {"eval fp32+kernel": ("fp32", "kernel"),
              "eval fp32+fused": ("fp32", "fused"),
              "eval fixed+kernel": ("fixed", "kernel"),
              "eval fixed+fused": ("fixed", "fused")}
PATH_KERNELS.update({n: PATH_KERNELS["window perf"] if path == "fused"
                     else PATH_KERNELS["window paper+kernel"]
                     for n, (_, path) in TRAIN_EVAL.items()})
PATH_KERNELS["mining paper+kernel"] = PATH_KERNELS["paper+kernel"]
PATH_KERNELS["cli kernel"] = PATH_KERNELS["paper+kernel"]
# the serve phase: session.serve() of each configuration answers frames
# through its dense kernels and windows through its window path
SERVE_CONFIGS = {"serve paper+kernel": ("paper+kernel",
                                        "window paper+kernel"),
                 "serve quant": ("quant", "window quant")}
PATH_KERNELS.update({n: PATH_KERNELS[d] + PATH_KERNELS[w]
                     for n, (d, w) in SERVE_CONFIGS.items()})
# each client thread's traffic: 640x480 and 1280x720 seeded scenes (the
# second bucket parks in the backlog), make_windows windows, and one
# malformed frame of each of serve/faults.py:malformed_frame's kinds
# (the rng seeds that draw rank 1, empty, rank 4 and tiny f64)
SERVE_CLIENTS, SERVE_VGA, SERVE_HD, SERVE_WINDOWS = 3, 8, 2, 64
MALFORMED_SEEDS = (11, 1, 4, 0)
SERVE_REPS = 3                 # timing: reps in turns after a warm-up
CHAOS_FRAMES = 10
# window configuration -> (preset, classify_windows path)
WINDOW_CONFIGS = {"window paper+kernel": ("paper", "kernel"),
                  "window perf": ("perf", "fused"),
                  "window quant+kernel": ("quant", "kernel"),
                  "window quant": ("quant", "fused")}

KERNELS = {
    "dense_grad_hist": ("src/repro_torch/csrc/dense_grad_hist.cu",
                        "src/repro/kernels/dense_grad_hist.py:62"),
    "dense_block_norm": ("src/repro_torch/csrc/dense_block_norm.cu",
                         "src/repro/kernels/dense_block_norm.py:41"),
    "dense_fused_hog": ("src/repro_torch/csrc/dense_fused_hog.cu",
                        "src/repro/kernels/fused_hog.py:137"),
    "score_matmul": ("src/repro_torch/csrc/score_matmul.cu",
                     "src/repro/kernels/svm_matmul.py:80"),
    "score_matmul_int8": ("src/repro_torch/csrc/score_matmul_int8.cu",
                          "src/repro/kernels/svm_matmul.py:118"),
    "hog_gradient": ("src/repro_torch/csrc/hog_gradient.cu",
                     "src/repro/kernels/hog_gradient.py:139"),
    "cell_hist": ("src/repro_torch/csrc/cell_hist.cu",
                  "src/repro/kernels/cell_hist.py:46"),
    "block_norm": ("src/repro_torch/csrc/block_norm.cu",
                   "src/repro/kernels/block_norm.py:41"),
    "fused_hog": ("src/repro_torch/csrc/fused_hog.cu",
                  "src/repro/kernels/fused_hog.py:75"),
    "svm_scores": ("src/repro_torch/csrc/svm_scores.cu",
                   "src/repro/kernels/svm_matmul.py:38"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                        "src/repro/kernels/flash_attention.py:86"),
}
# flash_attention's two routes (kernels/flash_attention.py:route), each a
# mode of its entry in the kernels line
FLASH_SOURCES = {"sm90": "src/repro_torch/csrc/flash_attention_sm90.cu",
                 "cuda_core": "src/repro_torch/csrc/flash_attention.cu"}
DENSE_KERNELS = tuple(KERNELS)[:5]
WINDOW_KERNELS = tuple(KERNELS)[5:10]

# the mode and group (frame, or window batch) whose numbers stand at the
# top level of a kernel's entry in the kernels line (every mode and group
# is under "modes")
MAIN_MODE = {"dense_grad_hist": "sector", "dense_block_norm": "rsqrt",
             "dense_fused_hog": "sector", "score_matmul": "f32",
             "score_matmul_int8": "int8", "hog_gradient": "sector",
             "cell_hist": "sector", "block_norm": "rsqrt",
             "fused_hog": "sector", "svm_scores": "f32",
             "flash_attention": "sm90"}
MAIN_GROUP = dict.fromkeys(DENSE_KERNELS, "640x480")
MAIN_GROUP.update(dict.fromkeys(WINDOW_KERNELS, "B512"))
MAIN_GROUP["flash_attention"] = "B4xS512"
# the per-group numbers summarize() keeps, in the order the check lines print
GROUP_FIELDS = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                "bound_by")

# where the tensors live; every phase runs on the card
DEV = "cuda"


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
    return "not measured" if ms is None else f"{ms:.4g} ms"


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
    when the profiler saw no such kernel in two tries."""
    for _ in range(2):
        times = device_times(torch, fn, reps)
        us = sum(t for k, (_, t) in times.items() if symbol in k)
        if us > 0:
            return us / 1e3 / reps
    return None


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
        0, 255, (ph, pw)).astype(np.float32)).to(DEV)
    levels = prog.pyramid(gray)
    hcfg = det.cfg.hog
    bh, bw = hcfg.blocks_hw
    blocks = [stages.dense_blocks(g, hcfg, det.cfg.backend) for g in levels]
    contribs = [torch.zeros(b.shape[:2] + (bh * bw,), device=DEV)
                for b in blocks]
    boxes = torch.from_numpy(prog.boxes).to(DEV)
    scores = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, len(prog.boxes)).astype(np.float32)).to(DEV)

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

def code_flips(got, want):
    """Elements where a fixed-mode block grid differs from its plain
    version, after checking no element differs by more than one int8 code
    step of its block (the fixed chain's contract, tests/test_fixed_point.py
    :221)."""
    step = want.abs().amax(-1, keepdim=True) * (1.0 / 127.0)
    diff = (got - want).abs()
    need(bool((diff <= step + 1e-6).all()),
         f"a block element moved by more than one int8 code step "
         f"(max diff {float(diff.max())})")
    return int((diff > 1e-6).sum())


def hog_op_s(mode: str, pixels: int = 0, nblocks: int = 0,
             norm: str = "rsqrt", chain: bool = True,
             hist: bool = True) -> float:
    """Least seconds of HOG work on the H100's CUDA cores: ``pixels``
    through the mag/bin chain (``chain``) and their histogram adds
    (``hist``), ``nblocks`` through the ``norm`` tail (all f32). Each
    pipe's operations over its own rate, int32 over INT32_OPS and f32 over
    F32_NOFMA_OPS; the two pipes run side by side, so the slower one."""
    i32, f32 = PIXEL_OPS[mode] if chain else (0, 0)
    if hist:
        i32, f32 = ((i32 + HIST_OPS, f32) if mode == "fixed"
                    else (i32, f32 + HIST_OPS))
    return max(pixels * i32 / INT32_OPS,
               (pixels * f32 + nblocks * BLOCK_OPS[norm]) / F32_NOFMA_OPS)


def timed_row(torch, kernel, where, shape, mode, e, fn, plain_fn, lib_fn,
              nbytes, op_s, symbol, flips=None) -> dict:
    """One kernel at one shape and mode: its error against the plain
    version, and kernel, device, plain, library and bound milliseconds
    (``op_s``: the least seconds of its operations). ``lib_fn`` is one
    PyTorch call of the same function, or None: its ``library_ms`` is
    the device time of every kernel it launches (torch.profiler, as the
    kernel's ``device_ms``), ``library_call_ms`` its CUDA-event time per
    back-to-back call (as the kernel's ``ms``, host dispatch included)."""
    bound = max(nbytes / HBM_BPS, op_s) * 1e3
    lib = call = None
    if lib_fn is not None:
        lib, call = kernel_device_ms(torch, lib_fn, ""), cuda_ms(lib_fn)
    return {"kernel": kernel, "frame": where, "shape": list(shape),
            "mode": mode, "max_abs_err": e, "code_flips": flips,
            "ms": cuda_ms(fn),
            "device_ms": kernel_device_ms(torch, fn, symbol),
            "plain_ms": cuda_ms(plain_fn, reps=5), "library_ms": lib,
            "library_call_ms": call, "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BPS >= op_s
            else "operations"}


def check_kernels(torch, np) -> dict:
    import repro_torch.core.quant as quant
    import repro_torch.kernels.dense_block_norm as dbn
    import repro_torch.kernels.dense_grad_hist as dgh
    import repro_torch.kernels.fused_hog as fh
    import repro_torch.kernels.svm_matmul as sm

    gw = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")["svm_w"]
    rng = np.random.default_rng(0)
    dev = torch.device(DEV)
    shapes = [("640x480", (1,) + s) for s in level_shapes(480, 640)]
    shapes += [("1280x720", (1,) + s) for s in level_shapes(720, 1280)]
    shapes += [("ragged", RAGGED)]
    rows = []

    def record(*args, **kw):
        rows.append(timed_row(torch, *args, **kw))

    wt32 = torch.from_numpy(gw).to(dev).reshape(105, 36).T.contiguous()
    wq, _ = quant.quantize_weight_columns(wt32)
    wq = wq.contiguous()
    refusals = set()
    for where, shape in shapes:
        B, H, W = shape
        ch, cw = (H - 2) // 8, (W - 2) // 8
        pixels = B * ch * 8 * cw * 8
        nblocks = B * (ch - 1) * (cw - 1)
        # float modes: float gray; the fixed mode: integer-valued gray, as
        # the fixed chain's entry seam hands its kernels
        grays = {"float": torch.from_numpy(
            rng.uniform(0, 255, shape).astype(np.float32)).to(dev),
                 "fixed": torch.from_numpy(
            rng.integers(0, 256, shape).astype(np.float32)).to(dev)}
        fused = {}
        for mode, norm in MODE_NORMS.items():
            gray = grays["fixed" if mode == "fixed" else "float"]
            got = dgh.dense_grad_hist(gray, mode=mode)
            hist = dgh.dense_grad_hist_plain(gray, mode=mode)
            torch.cuda.synchronize()
            need(got.shape == hist.shape and got.dtype == hist.dtype,
                 f"dense_grad_hist {mode} {shape}: shape or dtype")
            diff = (got.float() - hist.float()).abs()
            e = float(diff.max())
            if mode == "fixed":      # int16 counts: exact
                need(torch.equal(got, hist),
                     f"dense_grad_hist fixed {shape}: max err {e}")
            else:
                need(bool((diff <= HIST_ATOL
                           + HIST_RTOL * hist.abs()).all()),
                     f"dense_grad_hist {mode} {shape}: max err {e}")
            record("dense_grad_hist", where, shape, mode, e,
                   lambda: dgh.dense_grad_hist(gray, mode=mode),
                   lambda: dgh.dense_grad_hist_plain(gray, mode=mode), None,
                   4 * gray.numel() + hist.element_size() * hist.numel(),
                   hog_op_s(mode, pixels), "dense_grad_hist_kernel")

            got = dbn.dense_block_norm(hist, mode=norm)
            wantb = dbn.dense_block_norm_plain(hist, mode=norm)
            torch.cuda.synchronize()
            e = float((got - wantb).abs().max())
            flips = None
            if mode == "fixed":
                flips = code_flips(got, wantb)
                need(flips <= 1e-3 * got.numel(),
                     f"dense_block_norm fixed {shape}: {flips} code flips")
            else:
                need(e <= BLOCK_ATOL, f"dense_block_norm {norm} {shape}: {e}")
            record("dense_block_norm", where, shape, norm, e,
                   lambda: dbn.dense_block_norm(hist, mode=norm),
                   lambda: dbn.dense_block_norm_plain(hist, mode=norm), None,
                   hist.element_size() * hist.numel() + 4 * wantb.numel(),
                   hog_op_s(mode, nblocks=nblocks, norm=norm),
                   "dense_block_norm_kernel", flips)

            got = fh.dense_fused_hog(gray, mode=mode)
            want = fh.dense_fused_hog_plain(gray, mode=mode)
            pair = dbn.dense_block_norm(dgh.dense_grad_hist(gray, mode=mode),
                                        mode=norm)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            # the same summation order: the pair is the fused kernel's
            # output bit for bit
            need(torch.equal(got, pair), f"dense_fused_hog {mode} {shape}: "
                 f"max |fused - pair| {float((got - pair).abs().max())}")
            flips = None
            fused[mode] = want
            if mode == "fixed":
                flips = code_flips(got, want)
                need(flips <= 1e-3 * got.numel(),
                     f"dense_fused_hog fixed {shape}: {flips} code flips")
            else:
                need(e <= BLOCK_ATOL, f"dense_fused_hog {mode} {shape}: {e}")
            record("dense_fused_hog", where, shape, mode, e,
                   lambda: fh.dense_fused_hog(gray, mode=mode),
                   lambda: fh.dense_fused_hog_plain(gray, mode=mode), None,
                   4 * gray.numel() + 4 * want.numel(),
                   hog_op_s(mode, pixels, nblocks, norm),
                   "dense_fused_hog_kernel", flips)

        blocks = fused["cordic"].reshape(-1, 36)
        M = blocks.shape[0]
        for dname, dt, peak in (("f32", torch.float32, F32_FLOPS),
                                ("bf16", torch.bfloat16, BF16_FLOPS)):
            flat = blocks.to(dt).contiguous()
            wt = wt32.to(dt).contiguous()
            got = sm.score_matmul(flat, wt)
            wantm = sm.score_matmul_plain(flat, wt)
            torch.cuda.synchronize()
            e = float((got - wantm).abs().max())
            need(e <= MATMUL_ATOL[dname], f"score_matmul {dname} {shape}: {e}")
            lib = (functools.partial(torch.matmul, flat, wt)
                   if dt == torch.float32
                   else bf16_library(torch, flat, wt, wantm, refusals))
            record("score_matmul", where, (M, 36, 105), dname, e,
                   lambda: sm.score_matmul(flat, wt),
                   lambda: sm.score_matmul_plain(flat, wt),
                   lib, flat.element_size() * (M * 36 + 36 * 105)
                   + 4 * M * 105, 2 * M * 36 * 105 / peak,
                   "score_matmul_kernel")

        # int8 scoring: the codes of the fixed blocks and of the golden
        # weights, as core/detector.py:score_blocks makes them
        q, _ = quant.quantize_blocks(fused["fixed"].reshape(-1, 36))
        got = sm.score_matmul_int8(q, wq)
        wanti = sm.score_matmul_int8_plain(q, wq)
        torch.cuda.synchronize()
        need(got.dtype == torch.int32 and torch.equal(got, wanti),
             f"score_matmul_int8 {shape}: not equal to its plain version")
        lib = int8_library(torch, q, wq, got, refusals)
        record("score_matmul_int8", where, (M, 36, 105), "int8", 0.0,
               lambda: sm.score_matmul_int8(q, wq),
               lambda: sm.score_matmul_int8_plain(q, wq), lib,
               M * 36 + 36 * 105 + 4 * M * 105, 2 * M * 36 * 105 / INT8_OPS,
               "score_matmul_int8_kernel")
    out = summarize(rows, DENSE_KERNELS, ("640x480", "1280x720"), 3)
    pair_levels(torch, rows, shapes)
    fused_levels(torch, rows, shapes)
    score_levels(torch, rows, shapes)
    check_scorer_edges(torch, np)
    return out


def _dev_us(rows, kernel, mode, shape) -> str:
    """A kernel's device us at one shape and mode from the timed rows (-
    where the profiler saw nothing)."""
    ms = next(r["device_ms"] for r in rows if r["kernel"] == kernel
              and r["mode"] == mode and r["shape"] == list(shape))
    return "-" if ms is None else f"{ms * 1e3:.2f}"


def _by_group(shapes, fmt) -> str:
    """fmt(shape) for each shape, a space between levels, " | " between
    groups (frame sizes)."""
    return " | ".join(" ".join(fmt(s) for w, s in shapes if w == g)
                      for g in dict.fromkeys(w for w, _ in shapes))


def pair_levels(torch, rows, shapes) -> None:
    """dense_grad_hist and dense_block_norm level by level: each one's
    device us, its plan's tile and CTAs (kernels/dense_grad_hist.py:
    dense_grad_hist_plan, kernels/dense_block_norm.py:dense_block_norm_plan)
    and resident warps per SM (the smaller of the card's occupancy and the
    grid's CTAs per SM, times the warps of a CTA; frame sizes only). Fails
    under 132 CTAs on a 640x480 level."""
    import repro_torch.kernels.dense_block_norm as dbn
    import repro_torch.kernels.dense_grad_hist as dgh
    import repro_torch.kernels.tile_plan as tp
    from repro_torch.kernels.mag_bin import mode_code

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def plans(mode, norm, s):
        B, H, W = s
        return (dgh.dense_grad_hist_plan(B, H, W, mode, sms),
                dbn.dense_block_norm_plan(B, (H - 2) // 8, (W - 2) // 8,
                                          norm, sms))

    sector = {s: plans("sector", "rsqrt", s) for _, s in shapes}
    print(f"  dense pair plans ({sms} SMs), tile:CTAs per level ("
          + " | ".join(dict.fromkeys(w for w, _ in shapes))
          + "): dense_grad_hist " + _by_group(shapes, lambda s: "{}x{}:{}"
                                              .format(*sector[s][0].tile,
                                                      sector[s][0].ctas))
          + "; dense_block_norm " + _by_group(shapes, lambda s: "{}x{}:{}"
                                              .format(*sector[s][1].tile,
                                                      sector[s][1].ctas))
          + "; == dense_fused_hog everywhere; below: us, warps/SM, "
          "grad_hist/block_norm", flush=True)
    frames = [(w, s) for w, s in shapes if w != "ragged"]
    for mode, norm in MODE_NORMS.items():
        ps = {s: plans(mode, norm, s) for _, s in shapes}
        for i, (w, s) in enumerate(shapes[:3]):
            for kernel, p in zip(("dense_grad_hist", "dense_block_norm"),
                                 ps[s]):
                need(p.ctas >= 132, f"{kernel} {w} level {i}: {p.ctas} CTAs")
        warps = {s: (ps[s][0].resident_warps(tp.occupancy(
            "dense_grad_hist", mode_code(mode), ps[s][0]), sms),
                     ps[s][1].resident_warps(tp.occupancy(
                         "dense_block_norm", dbn.norm_code(norm), ps[s][1]),
                         sms)) for _, s in frames}
        print(f"  dense pair {mode}/{norm}: " + _by_group(
            shapes, lambda s: _dev_us(rows, "dense_grad_hist", mode, s) + "/"
            + _dev_us(rows, "dense_block_norm", norm, s)) + "; "
            + _by_group(frames, lambda s: "{:.1f}/{:.1f}".format(*warps[s])),
            flush=True)


def fused_levels(torch, rows, shapes) -> None:
    """dense_fused_hog level by level: its device time, and its plan's
    tile, CTAs, resident warps per SM (as pair_levels) and recomputed
    cells. Fails at 640x480 below 132 CTAs on any level or 16 resident
    warps per SM on the largest."""
    import repro_torch.kernels.fused_hog as fh

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {(m, s): fh.dense_plan(*s, m, sms=sms) for m in MODE_NORMS
             for _, s in shapes}
    sector = {s: plans["sector", s] for _, s in shapes}
    print(f"  dense_fused_hog plan ({sms} SMs), per level: tile "
          + _by_group(shapes, lambda s: "{}x{}".format(*sector[s].tile))
          + "; CTAs " + _by_group(shapes, lambda s: str(sector[s].ctas))
          + "; recompute "
          + _by_group(shapes, lambda s: f"{sector[s].recompute():.2f}")
          + "; below: device us, warps/SM", flush=True)
    for mode in MODE_NORMS:
        warps = {s: plans[mode, s].resident_warps(
            fh.dense_occupancy(plans[mode, s], mode), sms) for _, s in shapes}
        for i, (w, s) in enumerate(shapes[:3]):
            need(plans[mode, s].ctas >= 132, f"dense_fused_hog {w} level "
                                             f"{i}: {plans[mode, s].ctas} CTAs")
        need(warps[shapes[0][1]] >= 16, f"dense_fused_hog {mode} "
             f"{shapes[0][0]} level 0: {warps[shapes[0][1]]:.1f} warps/SM")
        print(f"  dense_fused_hog {mode}: " + _by_group(
            shapes, lambda s: _dev_us(rows, "dense_fused_hog", mode, s))
            + "; " + _by_group(shapes, lambda s: f"{warps[s]:.1f}"),
            flush=True)


def score_levels(torch, rows, shapes) -> None:
    """One line per scorer dtype, level by level: the kernel's device us
    and the library call's (torch.profiler, every kernel it launches; -
    where the profiler saw nothing), and the launch plan's CTAs x rows of
    the busiest CTA (kernels/svm_matmul.py:score_plan)."""
    import repro_torch.kernels.svm_matmul as sm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = list(dict.fromkeys(w for w, _ in shapes))
    for kernel, mode, dt in (("score_matmul", "f32", torch.float32),
                             ("score_matmul", "bf16", torch.bfloat16),
                             ("score_matmul_int8", "int8", torch.int8)):
        text = []
        for g in groups:
            parts = []
            for r in rows:
                if (r["kernel"], r["mode"], r["frame"]) != (kernel, mode, g):
                    continue
                plan = sm.score_plan(r["shape"][0], 105, dt, sms)
                parts.append("/".join(
                    "-" if x is None else f"{x * 1e3:.2f}"
                    for x in (r["device_ms"], r["library_ms"]))
                    + f" {plan.grid}x{plan.rows}")
            text.append(f"{g} " + " ".join(parts))
        legend = " per level, device/library us, CTAs x rows" \
            if mode == "f32" else ""
        print(f"  {kernel} {mode}{legend}: " + " | ".join(text), flush=True)


def check_scorer_edges(torch, np) -> None:
    """The scorers against their plain versions where the plan and the
    copies have edges: M = SCORER_TAILS (one to 34 CTAs, a ragged last
    unit), x and w at odd offsets of a flat buffer (the element-wise
    copies), and two other widths (a partial int8 word at K = 35; the
    widest shape the wrapper takes, K = 64 and N = 128). The 1280x720
    levels take the shared-memory opt-in above 48 KB."""
    import repro_torch.kernels.svm_matmul as sm
    rng = np.random.default_rng(5)
    worst = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16),
                     ("int8", torch.int8)):
        cases = [(m, 36, 105, False) for m in SCORER_TAILS]
        cases += [(133, 36, 105, True), (4524, 36, 105, True),
                  (133, 35, 50, False), (133, 64, 128, False)]
        for M, K, N, odd in cases:
            def draw(n, lo, hi):
                if name == "int8":
                    a = rng.integers(-127, 128, n).astype(np.int8)
                else:
                    a = rng.uniform(lo, hi, n).astype(np.float32)
                buf = torch.from_numpy(a).to(DEV).to(dt)
                return buf[1:] if odd else buf[:n - 1]
            x = draw(M * K + 1, 0, 0.5).view(M, K)
            w = draw(K * N + 1, -0.1, 0.1).view(K, N)
            what = f"{name} M={M} K={K} N={N}" + (" odd" if odd else "")
            need((x.data_ptr() % 16 != 0) == odd, f"{what}: alignment")
            if name == "int8":
                got = sm.score_matmul_int8(x, w)
                need(torch.equal(got, sm.score_matmul_int8_plain(x, w)),
                     f"score_matmul_int8 {what}: not equal")
                e = 0.0
            else:
                got = sm.score_matmul(x, w)
                e = float((got - sm.score_matmul_plain(x, w)).abs().max())
                need(e <= MATMUL_ATOL[name], f"score_matmul {what}: {e}")
            torch.cuda.synchronize()
            worst[name] = max(worst.get(name, 0.0), e)
    print(f"  scorer edges (M {'/'.join(map(str, SCORER_TAILS))}; x and w "
          f"at odd offsets, M 133 and 4524; K35xN50; K64xN128), max err vs "
          f"plain: f32 {worst['f32']:.2e}, bf16 {worst['bf16']:.2e}, int8 "
          f"equal", flush=True)


def bf16_library(torch, flat, wt, want, refusals):
    """One call with f32 output from bf16 inputs, where torch has it
    (torch.mm's out_dtype), else torch.matmul with bf16 output (said once)."""
    try:
        out = torch.mm(flat, wt, out_dtype=torch.float32)
        torch.cuda.synchronize()
    except (TypeError, RuntimeError):
        if "bf16" not in refusals:
            refusals.add("bf16")
            print("  (bf16 library: torch.matmul, bf16 output)", flush=True)
        return functools.partial(torch.matmul, flat, wt)
    need(float((out - want).abs().max()) <= MATMUL_ATOL["bf16"],
         "torch.mm(out_dtype=f32) disagrees with score_matmul_plain")
    return functools.partial(torch.mm, flat, wt, out_dtype=torch.float32)


def int8_library(torch, q, wq, want, refusals):
    """torch._int_mm on K padded to 40 and N to 112 (its int8 GEMM wants
    multiples of 8), the padding made outside the timing, with the weights
    row-major and, where cuBLASLt refuses that, column-major; None where
    it refuses both. Each reason is printed once."""
    import torch.nn.functional as F
    qp = F.pad(q, (0, 40 - q.shape[1])).contiguous()
    wp = F.pad(wq, (0, 112 - wq.shape[1], 0, 40 - wq.shape[0])).contiguous()
    for layout, w in (("row-major", wp),
                      ("column-major", wp.t().contiguous().t())):
        try:
            out = torch._int_mm(qp, w)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            why = (f"torch._int_mm refused {tuple(qp.shape)}@"
                   f"{tuple(w.shape)} {layout}: "
                   f"{str(exc).splitlines()[0][12:40]}")
            if layout not in refusals:
                refusals.add(layout)
                print(f"  score_matmul_int8 library: {why}", flush=True)
            continue
        need(torch.equal(out[:, :want.shape[1]], want),
             "torch._int_mm disagrees with score_matmul_int8")
        return functools.partial(torch._int_mm, qp, w)
    return None


def _sum(rows, key):
    vals = [r[key] for r in rows]
    return None if None in vals else sum(vals)


def _g(x) -> str:
    return "-" if x is None else f"{x:.4g}"


def summarize(rows, names, groups, per_group: int, shown=None) -> dict:
    """One line per kernel x mode: the worst error over every shape and,
    per group of ``shown`` (default all; a frame size: the sum over its
    three pyramid levels; or a window batch), device / plain / bound /
    library ms (the call's CUDA-event ms is in the kernels line). Returns
    {kernel: {mode: {group: sums}, "max_abs_err": worst}}."""
    shown = groups if shown is None else shown
    out = {}
    for k in names:
        out[k] = {"max_abs_err": 0.0}
        for mode in dict.fromkeys(r["mode"] for r in rows
                                  if r["kernel"] == k):
            sel = [r for r in rows if r["kernel"] == k and r["mode"] == mode]
            e = max(r["max_abs_err"] for r in sel)
            flips = _sum(sel, "code_flips")
            out[k]["max_abs_err"] = max(out[k]["max_abs_err"], e)
            out[k][mode] = {"max_abs_err": e}
            if flips is not None:
                out[k][mode]["code_flips"] = flips
            text = []
            for group in groups:
                fr = [r for r in sel if r["frame"] == group]
                need(len(fr) == per_group,
                     f"missing {group} timings of {k} {mode}")
                sums = {key: _sum(fr, key)
                        for key in GROUP_FIELDS[:-1] + ("library_call_ms",)}
                sums["bound_by"] = fr[0]["bound_by"]
                out[k][mode][group] = sums
                if group in shown:
                    text.append(f"{group} " + "/".join(
                        _g(sums[key]) for key in GROUP_FIELDS[1:-1])
                        + f" ({sums['bound_by'][:3]})")
            by = {out[k][mode][g]["bound_by"] for g in shown}
            if len(by) == 1:             # one bound for every group: once
                text = [t.rsplit(" (", 1)[0] for t in text]
            print(f"  {k} {mode} err {e:.2e}"
                  + (f" flips {flips}" if flips is not None else "")
                  + " " + "; ".join(text)
                  + (f" ({by.pop()[:3]})" if len(by) == 1 else ""),
                  flush=True)
    return out


def check_window_kernels(torch, np) -> dict:
    """Phase 3b: each window kernel against its plain version on the card
    at every WINDOW_BATCHES size and in every mode, timed."""
    import repro_torch.kernels.block_norm as bn
    import repro_torch.kernels.cell_hist as chist
    import repro_torch.kernels.dense_block_norm as dbn
    import repro_torch.kernels.fused_hog as fh
    import repro_torch.kernels.hog_gradient as hg
    import repro_torch.kernels.svm_matmul as sm

    g = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")
    w = torch.from_numpy(g["svm_w"]).to(DEV)
    bias = torch.from_numpy(np.asarray(g["svm_b"], np.float32)).to(DEV)
    rng = np.random.default_rng(3)
    rows, tail_inputs = [], {}

    def record(*args, **kw):
        rows.append(timed_row(torch, *args, **kw))

    for where, B in WINDOW_BATCHES:
        shape = (B, 130, 66)
        pixels, nblocks = B * 128 * 64, B * 15 * 7
        grays = {"float": torch.from_numpy(
            rng.uniform(0, 255, shape).astype(np.float32)).to(DEV),
                 "fixed": torch.from_numpy(
            rng.integers(0, 256, shape).astype(np.float32)).to(DEV)}
        descs, hists = {}, {}
        for mode, norm in MODE_NORMS.items():
            gray = grays["fixed" if mode == "fixed" else "float"]
            tag = f"{mode} B={B}"
            mag, bins = hg.hog_gradient(gray, mode)
            pmag, pbins = hg.hog_gradient_plain(gray, mode)
            torch.cuda.synchronize()
            need(mag.dtype == pmag.dtype and mag.shape == pmag.shape
                 and bins.dtype == pbins.dtype,
                 f"hog_gradient {tag}: shape or dtype")
            nb = int((bins != pbins).sum())
            need(nb == 0, f"hog_gradient {tag}: {nb} bins differ")
            diff = (mag.double() - pmag.double()).abs()
            e = float(diff.max())
            if mode == "fixed":
                need(torch.equal(mag, pmag),
                     f"hog_gradient {tag}: integer magnitudes differ")
            else:
                need(bool((diff <= MAG_RTOL * pmag.abs()).all()),
                     f"hog_gradient {tag}: magnitude err {e}")
            record("hog_gradient", where, shape, mode, e,
                   lambda: hg.hog_gradient(gray, mode),
                   lambda: hg.hog_gradient_plain(gray, mode), None,
                   4 * gray.numel() + 8 * pixels,
                   hog_op_s(mode, pixels, hist=False),
                   "hog_gradient_kernel")

            # the same magnitudes and bins into both histogram versions
            hist = chist.cell_hist(pmag, pbins)
            phist = chist.cell_hist_plain(pmag, pbins)
            torch.cuda.synchronize()
            need(hist.dtype == phist.dtype and hist.shape == phist.shape,
                 f"cell_hist {tag}: shape or dtype")
            diff = (hist.float() - phist.float()).abs()
            e = float(diff.max())
            if mode == "fixed":
                need(torch.equal(hist, phist), f"cell_hist {tag}: {e}")
            else:
                need(bool((diff <= HIST_ATOL
                           + HIST_RTOL * phist.abs()).all()),
                     f"cell_hist {tag}: max err {e}")
            record("cell_hist", where, (B, 128, 64), mode, e,
                   lambda: chist.cell_hist(pmag, pbins),
                   lambda: chist.cell_hist_plain(pmag, pbins), None,
                   8 * pixels + phist.element_size() * phist.numel(),
                   hog_op_s(mode, pixels, chain=False),
                   "cell_hist_kernel")

            got = bn.block_norm(phist, mode=norm)
            want = bn.block_norm_plain(phist, mode=norm)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            flips = None
            if mode == "fixed":
                flips = code_flips(got, want)
                need(flips <= 1e-3 * got.numel(),
                     f"block_norm fixed B={B}: {flips} code flips")
            else:
                need(e <= BLOCK_ATOL, f"block_norm {norm} B={B}: {e}")
            need(torch.equal(got, dbn.dense_block_norm(phist, mode=norm)),
                 f"block_norm {norm} B={B}: not dense_block_norm(h) bit for "
                 "bit")
            hists[norm] = phist
            record("block_norm", where, tuple(phist.shape), norm, e,
                   lambda: bn.block_norm(phist, mode=norm),
                   lambda: bn.block_norm_plain(phist, mode=norm), None,
                   phist.element_size() * phist.numel() + 4 * want.numel(),
                   hog_op_s(mode, nblocks=nblocks, norm=norm),
                   "block_norm_kernel", flips)

            got = fh.fused_hog(gray, mode=mode)
            want = fh.fused_hog_plain(gray, mode=mode)
            torch.cuda.synchronize()
            need(got.shape == want.shape == (B, 3780),
                 f"fused_hog {tag}: shape")
            e = float((got - want).abs().max())
            flips = None
            if mode == "fixed":
                flips = code_flips(got.reshape(B, -1, 36),
                                   want.reshape(B, -1, 36))
                need(flips <= 1e-3 * got.numel(),
                     f"fused_hog fixed B={B}: {flips} code flips")
            else:
                need(e <= BLOCK_ATOL, f"fused_hog {tag}: {e}")
            dense = fh.dense_fused_hog(gray, mode=mode).reshape(B, -1)
            torch.cuda.synchronize()
            need(torch.equal(got, dense), f"fused_hog {tag}: not "
                 "dense_fused_hog(g).reshape(B, -1) bit for bit")
            descs[mode] = want
            record("fused_hog", where, shape, mode, e,
                   lambda: fh.fused_hog(gray, mode=mode),
                   lambda: fh.fused_hog_plain(gray, mode=mode), None,
                   4 * gray.numel() + 4 * want.numel(),
                   hog_op_s(mode, pixels, nblocks, norm),
                   "fused_hog_kernel", flips)

        for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            feats = descs["sector"].to(dt).contiguous()
            got = sm.svm_scores(feats, w, bias)
            want = sm.svm_scores_plain(feats, w, bias)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            need(e <= SVM_ATOL, f"svm_scores {dname} B={B}: {e}")
            lib = None          # no one call scores bf16 rows by f32 weights
            if dt == torch.float32:
                lib_out = torch.addmv(bias, feats, w)
                torch.cuda.synchronize()
                need(float((lib_out - want).abs().max()) <= SVM_ATOL,
                     "torch.addmv disagrees with svm_scores_plain")
                lib = functools.partial(torch.addmv, bias, feats, w)
            record("svm_scores", where, (B, 3780), dname, e,
                   lambda: sm.svm_scores(feats, w, bias),
                   lambda: sm.svm_scores_plain(feats, w, bias), lib,
                   feats.element_size() * feats.numel() + 4 * 3780 + 4
                   + 4 * B, 2 * B * 3780 / F32_NOFMA_OPS,
                   "svm_scores_kernel")
        if B in (11, 512):
            tail_inputs[B] = (hists, descs["sector"])
    # B 11 is checked (its error is in err) but its times are not printed
    out = summarize(rows, WINDOW_KERNELS, [g for g, _ in WINDOW_BATCHES], 1,
                    shown=("B64", "B512"))
    window_plans(torch, np, rows)
    out["plans"] = tail_plans(torch, np, rows, tail_inputs, w, bias)
    return out


def window_plans(torch, np, rows) -> None:
    """hog_gradient and fused_hog by batch: each launch plan's band (R
    output rows, k block rows), CTAs, resident warps per SM (as
    pair_levels, per mode) and recompute ratio (kernels/hog_gradient.py:
    hog_gradient_plan, kernels/fused_hog.py:window_plan); then per kernel
    and mode the device us at B 64, 512 and 5,949 (that last timed only,
    beside its bound). Fails under 132 CTAs at B >= 64."""
    import repro_torch.kernels.fused_hog as fh
    import repro_torch.kernels.hog_gradient as hg
    import repro_torch.kernels.tile_plan as tp
    from repro_torch.kernels.mag_bin import mode_code

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sizes = [B for _, B in sorted(WINDOW_BATCHES, key=lambda x: x[1])]
    sizes.append(N_FRAME_WINDOWS)
    plans = {("hog_gradient", m, B): hg.hog_gradient_plan(B, 130, 66, sms)
             for m in MODE_NORMS for B in sizes}
    plans.update({("fused_hog", m, B): fh.window_plan(B, 130, 66, m, sms)
                  for m in MODE_NORMS for B in sizes})
    for (k, m, B), p in plans.items():
        need(B < 64 or p.ctas >= sms, f"{k} {m} B={B}: {p.ctas} CTAs")
    print(f"  window plans ({sms} SMs), band:CTAs:recompute at B "
          + "/".join(map(str, sizes)) + ": " + "; ".join(
              k + " " + " ".join("{}:{}:{:.3g}".format(
                  p.band, p.ctas, p.recompute())
                  for p in (plans[k, "sector", B] for B in sizes))
              for k in ("hog_gradient", "fused_hog"))
          + "; == dense_fused_hog at B 64/512/11, every band at B 11; "
          "below: us B64/512/5949, bound, warps/SM",
          flush=True)
    # every compiled band, not only the plans' picks: hog_gradient's equal
    # to the wrapper's output, fused_hog's to dense_fused_hog's, at B 11
    rng = np.random.default_rng(4)
    for mode in MODE_NORMS:
        g = rng.uniform(0, 255, (11, 130, 66))
        g = torch.from_numpy((np.rint(g) if mode == "fixed" else g)
                             .astype(np.float32)).to(DEV)
        want_g = hg.hog_gradient(g, mode)
        want_f = fh.dense_fused_hog(g, mode=mode).reshape(11, -1)
        for r in hg.GRADIENT_BANDS:
            got = hg._launch(g, mode, hg.gradient_plan_at(r, 11, 130))
            need(all(map(torch.equal, got, want_g)),
                 f"hog_gradient {mode} band {r}: not the wrapper's output")
        for k in fh.WINDOW_BANDS:
            got = fh._window_launch(g, 1e-2, mode, fh.window_plan_at(k, 11,
                                                                     130))
            need(torch.equal(got, want_f),
                 f"fused_hog {mode} band {k}: not dense_fused_hog's")
    shape = (N_FRAME_WINDOWS, 130, 66)
    grays = {"float": torch.from_numpy(
        rng.uniform(0, 255, shape).astype(np.float32)).to(DEV),
             "fixed": torch.from_numpy(
        rng.integers(0, 256, shape).astype(np.float32)).to(DEV)}
    pixels = N_FRAME_WINDOWS * 128 * 64
    for kernel in ("hog_gradient", "fused_hog"):
        for mode, norm in MODE_NORMS.items():
            gray = grays["fixed" if mode == "fixed" else "float"]
            if kernel == "hog_gradient":
                fn = functools.partial(hg.hog_gradient, gray, mode)
                nbytes = 4 * gray.numel() + 8 * pixels
                op_s = hog_op_s(mode, pixels, hist=False)
            else:
                fn = functools.partial(fh.fused_hog, gray, mode=mode)
                nbytes = 4 * gray.numel() + 4 * N_FRAME_WINDOWS * 3780
                op_s = hog_op_s(mode, pixels, N_FRAME_WINDOWS * 105, norm)
            big = kernel_device_ms(torch, fn, f"{kernel}_kernel", reps=10)
            dev = [_dev_us(rows, kernel, mode, (B, 130, 66))
                   for B in (64, 512)]
            warps = [plans[kernel, mode, B].resident_warps(tp.occupancy(
                kernel, mode_code(mode), plans[kernel, mode, B]), sms)
                     for B in sizes]
            print(f"  {kernel} {mode}: " + "/".join(dev) + "/"
                  + ("-" if big is None else f"{big * 1e3:.2f}")
                  + f" us; {max(nbytes / HBM_BPS, op_s) * 1e6:.2f}"
                  + "; " + " ".join(f"{w:.1f}" for w in warps), flush=True)


def tail_plans(torch, np, rows, inputs, w, bias) -> dict:
    """block_norm and svm_scores by batch: each launch plan
    (rows/threads/body:CTAs, rows a CTA:CTAs; kernels/block_norm.py:
    block_norm_plan, kernels/svm_matmul.py:svm_scores_plan); every
    compiled band of block_norm equal to dense_block_norm at B 11, the
    same rows the same svm_scores at B 11 and 512 and one row later (the
    other bf16 parity); a plan the kernels are not compiled for refused;
    then per kernel and mode (cell_hist too) the device us at B 64, 512
    and 5,949 (that last timed only), the B 5,949 bound and resident
    warps per SM. Fails under 132 CTAs where the batch has a CTA's rows
    for every SM. Returns {kernel: {group: plan}} for the kernels
    line."""
    import repro_torch.kernels.block_norm as bn
    import repro_torch.kernels.cell_hist as chist
    import repro_torch.kernels.dense_block_norm as dbn
    import repro_torch.kernels.hog_gradient as hg
    import repro_torch.kernels.svm_matmul as sm
    import repro_torch.kernels.tile_plan as tp

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sizes = (11, 64, 512, N_FRAME_WINDOWS)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    plans = {("block_norm", B): bn.block_norm_plan(B, 16, 8, "rsqrt", sms)
             for B in sizes}
    plans.update({("svm_scores", B): sm.svm_scores_plan(B, 3780,
                                                        torch.float32)
                  for B in sizes})
    for (k, B), p in plans.items():
        need(B < sms or p.ctas >= sms, f"{k} B={B}: {p.ctas} CTAs")
    bf = {B: sm.svm_scores_plan(B, 3780, torch.bfloat16) for B in sizes}
    shown = {"block_norm": {f"B{B}": "{}/{}/{}:{}".format(
        p.rows, p.threads, p.body, p.ctas) for B in sizes
        for p in [plans["block_norm", B]]},
             "svm_scores": {f"B{B}": "{}:{},{}:{}".format(
                 p.rows, p.ctas, bf[B].rows, bf[B].ctas) for B in sizes
                 for p in [plans["svm_scores", B]]}}
    for B in sizes:
        need(all(bn.block_norm_plan(B, 16, 8, n, sms) == plans["block_norm", B]
                 for n in ("nr", "fixed")),
             f"block_norm B={B}: the plan depends on the flavor")
        need(B < 2 * sms or bf[B].ctas >= sms, f"svm_scores bf16 B={B}: "
             f"{bf[B].ctas} CTAs")
    for norm, hist in inputs[11][0].items():
        want = dbn.dense_block_norm(hist, mode=norm)
        for k in bn.BLOCK_NORM_BANDS:
            need(torch.equal(bn._launch(hist, 1e-2, norm,
                                        bn.block_norm_plan_at(k, 11, 16)),
                             want), f"block_norm {norm} band {k}: not "
                 "dense_block_norm's")
    for name, dt in dts.items():
        f512 = inputs[512][1].to(dt).contiguous()
        s512 = sm.svm_scores(f512, w, bias)
        first = sm.svm_scores(f512[:11].contiguous(), w, bias)
        later = sm.svm_scores(torch.cat([f512[5:6], f512[:11]]), w,
                              bias)[1:]
        need(torch.equal(first, s512[:11]) and torch.equal(later, s512[:11]),
             f"svm_scores {name}: rows scored at B 11 (or one row later) "
             "unlike at B 512")
    hist = inputs[11][0]["rsqrt"]
    for what, fn in (
            ("block_norm band 2", lambda: bn._launch(
                hist, 1e-2, "rsqrt", bn.block_norm_plan_at((2, 64, 0), 11,
                                                           16))),
            ("svm_scores 3 rows", lambda: sm._svm_launch(
                inputs[11][1], w, bias, dataclasses.replace(
                    sm.svm_scores_plan(11, 3780, torch.float32), rows=3),
                torch.empty(11, device=DEV)))):
        try:
            fn()
        except RuntimeError:
            continue
        need(False, f"{what}: a plan the kernel is not built for ran")
    print("  tail plans at B " + "/".join(map(str, sizes)) + ": "
          + "; ".join(f"{k} {' '.join(v.values())}"
                      for k, v in shown.items())
          + " (rows/threads/body:CTAs; f32,bf16 rows:CTAs); bands == "
          "dense_block_norm, rows batch-free, others refused",
          flush=True)
    rng = np.random.default_rng(6)
    shape = (N_FRAME_WINDOWS, 130, 66)
    nb, px = N_FRAME_WINDOWS * 105, N_FRAME_WINDOWS * 128 * 64
    grads, big = {}, {}                  # by HOG mode; by norm flavor
    for mode in ("sector", "fixed"):
        g = rng.uniform(0, 255, shape)
        g = torch.from_numpy((np.rint(g) if mode == "fixed" else g)
                             .astype(np.float32)).to(DEV)
        grads[mode] = hg.hog_gradient(g, mode)
        big[MODE_NORMS[mode]] = chist.cell_hist(*grads[mode])
    big["nr"] = big["rsqrt"]
    desc = torch.from_numpy(rng.uniform(0, 0.4, (N_FRAME_WINDOWS, 3780))
                            .astype(np.float32)).to(DEV)
    work = [("cell_hist", m, functools.partial(chist.cell_hist, *grads[m]),
             8 * px + big[MODE_NORMS[m]].element_size()
             * big[MODE_NORMS[m]].numel(), hog_op_s(m, px, chain=False),
             None) for m in ("sector", "fixed")]
    work += [("block_norm", n, functools.partial(bn.block_norm, big[n],
                                                 mode=n),
              big[n].element_size() * big[n].numel() + 4 * nb * 36,
              hog_op_s("fixed" if n == "fixed" else "sector", nblocks=nb,
                       norm=n), bn.norm_code(n))
             for n in ("rsqrt", "nr", "fixed")]
    for name, dt in dts.items():
        x = desc.to(dt)
        work.append(("svm_scores", name, functools.partial(sm.svm_scores, x,
                                                           w, bias),
                     x.element_size() * x.numel() + 4 * 3780 + 4
                     + 4 * N_FRAME_WINDOWS,
                     2 * x.numel() / F32_NOFMA_OPS, int(dt != torch.float32)))
    for kernel, mode, fn, nbytes, op_s, code in work:
        t = kernel_device_ms(torch, fn, f"{kernel}_kernel", reps=10)
        dev = [_dev_us(rows, kernel, mode, shape) for shape in (
            ((B, 128, 64) if kernel == "cell_hist" else (B, 16, 8, 9)
             if kernel == "block_norm" else (B, 3780)) for B in (64, 512))]
        warps = ""
        if code is not None:
            ps = [bn.block_norm_plan(B, 16, 8, mode, sms)
                  if kernel == "block_norm" else
                  sm.svm_scores_plan(B, 3780, dts[mode]) for B in sizes]
            warps = "; " + " ".join("{:.1f}".format(p.resident_warps(
                tp.occupancy(kernel, code, p), sms)) for p in ps)
        print(f"  {kernel} {mode}: " + "/".join(dev) + "/"
              + ("-" if t is None else f"{t * 1e3:.2f}")
              + f" us; {max(nbytes / HBM_BPS, op_s) * 1e6:.2f}"
              + warps, flush=True)
    return shown


def flash_bf16_matched(torch, q, k, v, block_k=64, causal=True):
    """flash_attention's function in f32 from bf16 q, k, v, rounding as
    a kernel with ``block_k``-key tiles does: f32 scores times the f32
    1/sqrt(hd), p = exp(s - m_t) rounded to bf16 before the P.V product,
    m_t the running row max after the key's tile, l the sum of the
    unrounded p."""
    import torch.nn.functional as F

    B, H, S, hd = q.shape
    rep = H // k.shape[1]
    kk, vv = (x.float().repeat_interleave(rep, 1) for x in (k, v))
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if causal:
        s.masked_fill_(~torch.ones(S, S, dtype=torch.bool,
                                   device=q.device).tril(), -1e30)
    nt = -(-S // block_k)
    tiles = F.pad(s, (0, nt * block_k - S), value=-1e30).view(
        B, H, S, nt, block_k)
    run = tiles.amax(-1).cummax(-1).values        # m after each tile
    mt = run.repeat_interleave(block_k, -1)[..., :S]
    mfin = run[..., -1:]
    p = torch.exp(s - mt).bfloat16().float() * torch.exp(mt - mfin)
    l = torch.exp(s - mfin).sum(-1, keepdim=True)
    return (p @ vv) / l


def check_flash(torch, np) -> dict:
    """Phase 3c: flash_attention against its plain version on the card,
    and (causal) against the port's _sdpa with the causal make_mask, at
    FLASH_SMALL (contiguous (B, H, S, hd)), FLASH_OTHER_HD and qwen3-14b's
    prefill shapes (the (B, S, H, hd) views prefill passes) in f32 and
    bf16 on the same inputs. Each call must launch the route that
    fa.route names; every bf16 run is also held to flash_bf16_matched with
    its route's key tile. At full width both routes run in bf16 and are
    timed. Tolerances atol + rtol * |want|."""
    import dataclasses as dc

    import torch.nn.functional as F

    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.models.attention import _sdpa, make_mask

    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    rng = np.random.default_rng(4)
    lm = get_config(LM_ARCH)
    worst = {"f32": 0.0, "bf16": 0.0}
    ratios = {r: 0.0 for r in fa.ROUTES}     # worst share of matched limit
    # the key tile each route rounds p against (flash_bf16_matched's block_k)
    block_k = {"cuda_core": fa.BLOCK_K, "sm90": fa.SM90_BLOCK_K}
    rows = []

    def held(got, want, dt, what, tol=None):
        atol, rtol = tol or (FLASH_TOL[dt], FLASH_TOL[dt])
        diff = (got.float() - want.float()).abs()
        lim = atol + rtol * want.float().abs()
        ratio = float((diff / lim).max())
        need(ratio <= 1, f"flash_attention {what}: max err "
                         f"{float(diff.max())}, {ratio:.3g} of the limit")
        return float(diff.max()), ratio

    def draw(B, H, K, S, hd):
        return [torch.from_numpy(rng.standard_normal(
            (B, S, n, hd), dtype=np.float32)).to(DEV) for n in (H, K, K)]

    def matched(got, q, k, v, causal, r, what):
        em, ratio = held(got, flash_bf16_matched(
            torch, q, k, v, block_k[r], causal), "bf16",
            f"{what} vs the bf16-matched plain version", FLASH_MATCHED_TOL)
        ratios[r] = max(ratios[r], ratio)
        return em, ratio

    def case(arrs, causal, dt, bshd):
        q, k, v = (x.to(dts[dt]).transpose(1, 2) for x in arrs)
        if not bshd:
            q, k, v = (x.contiguous() for x in (q, k, v))
        B, H, S, hd = q.shape
        r = fa.route(q.dtype, hd)
        what = (f"B{B} H{H} K{k.shape[1]} S{S} hd{hd} {dt} causal={causal} "
                f"({r})")
        before = dict(fa.flash_attention.route_launches)
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        need(fa.flash_attention.route_launches
             == {**before, r: before[r] + 1},
             f"flash_attention {what}: did not launch the {r} route once")
        need(got.shape == want.shape and got.dtype == want.dtype
             and got.stride() == q.stride(), f"flash_attention {what}: "
             f"shape, dtype or layout")
        e = held(got, want, dt, what)[0]
        if causal:
            cfg = dc.replace(lm, n_heads=H, n_kv_heads=k.shape[1],
                             head_dim=hd, dtype=dts[dt])
            pos = torch.arange(S, device=DEV).expand(B, S)
            ref = _sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), make_mask(pos, pos),
                        cfg).transpose(1, 2)
            e = max(e, held(got, ref, dt, what + " vs _sdpa")[0])
        mr = matched(got, q, k, v, causal, r, what)[1] if dt == "bf16" \
            else None
        worst[dt] = max(worst[dt], e)
        return q, k, v, got, e, mr

    for B, H, K, S, hd, causal, dt in FLASH_SMALL + FLASH_OTHER_HD:
        case(draw(B, H, K, S, hd), causal, dt, bshd=False)
    print(f"  flash_attention {len(FLASH_SMALL)} small shapes + "
          f"{len(FLASH_OTHER_HD)} bf16 at hd 32, each on its route: max err "
          f"vs plain and _sdpa f32 {worst['f32']:.2e} (tol 1e-5), bf16 "
          f"{worst['bf16']:.2e} (tol 3e-2); matched limit share: "
          + ", ".join(f"{r} {x:.2f}" for r, x in ratios.items()),
          flush=True)
    full = []
    for where, B, S in LM_BATCHES:
        H, K, hd = lm.n_heads, lm.n_kv_heads, lm.hd
        arrs = draw(B, H, K, S, hd)
        e32 = case(arrs, True, "f32", bshd=True)[-2]
        q, k, v, got, e, m_new = case(arrs, True, "bf16", bshd=True)
        old = fa.launch_cuda_core(q, k, v)
        e_old = held(old, fa.flash_attention_plain(q, k, v), "bf16",
                     f"{where} bf16 (cuda_core)")[0]
        m_old = matched(old, q, k, v, True, "cuda_core", where)[1]
        full.append(f"{where} f32 {e32:.2e}; bf16 sm90 {e:.2e} (matched "
                    f"{m_new:.2f}), cuda_core {e_old:.2e} ({m_old:.2f})")
        qc, kc, vc = (x.contiguous() for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                  enable_gqa=True)

        held(library(), fa.flash_attention_plain(q, k, v), "bf16",
             f"{where}: the library call vs plain")
        nbytes = 2 * B * S * (2 * H + 2 * K) * hd
        ops = 4 * B * H * hd * S * (S + 1) // 2
        for r, e_r, fn in (("sm90", e, fa.launch_sm90),
                           ("cuda_core", e_old, fa.launch_cuda_core)):
            rows.append(timed_row(
                torch, "flash_attention", where, (B, H, K, S, hd), r, e_r,
                lambda fn=fn: fn(q, k, v),
                lambda: fa.flash_attention_plain(q, k, v), library,
                nbytes, ops / BF16_FLOPS, "flash_attention_kernel"))
    print(f"  flash_attention full width, (B, S, H, hd) strides, err vs "
          f"plain (tol + tol x |want|), matched share: "
          + "; ".join(full), flush=True)
    out = summarize(rows, ("flash_attention",),
                    [g for g, _, _ in LM_BATCHES], 1)
    out["flash_attention"]["max_abs_err"] = max(worst.values())
    return out


# ------------------------------------------------------------- phase 4

def main_path(torch, np) -> dict:
    import repro_torch.api as api
    import repro_torch.data.synth_pedestrian as synth
    import repro_torch.kernels as kernels

    g = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")
    svm = {"w": g["svm_w"], "b": g["svm_b"]}

    def preset(name, dtype, **change):
        cfg = api.presets(name)
        return (cfg.replace(detector=dataclasses.replace(
            cfg.detector, score_threshold=THRESHOLD, **change)), dtype)

    configs = {
        "paper+kernel": preset("paper", "f32", backend="kernel"),
        "perf": preset("perf", "bf16"),
        "quant": preset("quant", "int8"),
        "quant+kernel": preset("quant", "int8", backend="kernel"),
    }
    frames = {(h, w): [synth.make_scene(np.random.default_rng(seed), h, w,
                                  n_people=3)[0] for seed in (0, 1)]
              for h, w in FRAME_SIZES}
    gpu = {n: api.DetectionSession(svm, c, device=DEV)
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
        launches[name] = check_launches(name, kernels.launch_counts())
    print(launch_line(launches), flush=True)

    # one line per configuration: each frame size's frames, "/" between
    # frames and " " between sizes
    report = {}
    for (name, hw), dets in results.items():
        dt = configs[name][1]
        sess = gpu[name]
        kept, deltas, rints = [], [], []
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
            kept.append(str(len(got)))
            deltas.append(f"{de:.1e}")
            if dt == "int8":
                rints.append(str(rint_flips(torch, sess, cpu[name], f)))
        for key, part in (("kept", kept), ("delta", deltas),
                          ("rint", rints)):
            report.setdefault((name, key), []).append("/".join(part))
    for name, (_, dt) in configs.items():
        flips = (f"; rint px unlike CPU "
                 + " ".join(report[(name, "rint")])
                 if dt == "int8" else "")
        print(f"  {name} " + "/".join(f"{w}x{h}" for h, w in frames)
              + f" x{len(frames[FRAME_SIZES[0]])}: kept "
              + " ".join(report[(name, "kept")]) + " = CPU, score delta "
              + " ".join(report[(name, "delta")])
              + f" (tol {SCORE_TOL[dt]:g}){flips}", flush=True)

    # ms/frame: the configurations in turns (the order rotating every
    # repetition), so host drift falls on all of them alike
    per_frame = {}
    names = list(gpu)
    for hw, fs in frames.items():
        total = dict.fromkeys(names, 0.0)
        for rep in range(-1, TIMING_REPS):            # rep -1 warms up
            for name in names[rep % len(names):] + names[:rep % len(names)]:
                t0 = time.perf_counter()
                for f in fs:
                    gpu[name].detect(f).block_until_ready()
                if rep >= 0:
                    total[name] += time.perf_counter() - t0
        for name in names:
            ms = total[name] * 1e3 / (TIMING_REPS * len(fs))
            per_frame[f"{name} {hw[1]}x{hw[0]}"] = ms
        legend = (" (detect + synchronize, host clock, in turns)"
                  if hw == FRAME_SIZES[0] else "")
        print(f"  ms/frame {hw[1]}x{hw[0]}{legend}: " + ", ".join(
                  f"{n} {per_frame[f'{n} {hw[1]}x{hw[0]}']:.3f}"
                  for n in names), flush=True)

    for h, w in FRAME_SIZES:
        key = f"{w}x{h}"
        split = frame_split(torch, np, gpu["paper+kernel"], h, w)
        split.update(frame_profile(torch, gpu["paper+kernel"],
                                   frames[(h, w)][0]))
        split["ms_per_frame"] = per_frame[f"paper+kernel {key}"]
        print(f"  split {key} (paper+kernel), ms: " + ", ".join(
            f"{k[:-3]} {split[k]:.4f}" for k in ("resize_ms", "hog_ms",
                                                "score_matmul_ms",
                                                "collate_ms", "topk_nms_ms"))
              + f"; launches/frame {split['device_launches_per_frame']:.0f},"
              f" busy ms {split['device_busy_ms']:.4f}, ms/frame "
              f"{split['ms_per_frame']:.4f}", flush=True)
        text = []
        for name in ("perf", "quant", "quant+kernel"):
            prof = frame_profile(torch, gpu[name], frames[(h, w)][0])
            ms = per_frame[f"{name} {key}"]
            text.append(f"{name} {prof['device_launches_per_frame']:.0f} "
                        f"{prof['device_busy_ms']:.4f} {ms:.4f} "
                        f"{1 - prof['device_busy_ms'] / ms:.4f}")
        legend = (", launches/frame, busy ms, ms/frame, idle"
                  if (h, w) == FRAME_SIZES[0] else "")
        print(f"  profile {key}{legend}: " + "; ".join(text), flush=True)
    return launches, configs, svm


def check_launches(name: str, counts: dict) -> dict:
    """Require one path's own kernels > 0 and every other kernel 0, its
    counts read right after its run (launch_line prints them)."""
    for k, n in counts.items():
        if k in PATH_KERNELS[name]:
            need(n > 0, f"kernel {k} was not launched on the {name} path")
        else:
            need(n == 0, f"kernel {k} launched {n} times on the {name} "
                         f"path, which should not run it")
    return counts


def launch_line(launches: dict) -> str:
    """Paths' launches, each checked by check_launches: each path's own
    kernels as _per_kernel gives them; every other kernel launched 0
    times on each."""
    return ("launches of each own kernel (others 0): " + "; ".join(
        f"{n.replace('window ', '')} " + _per_kernel(
            [c], PATH_KERNELS[n]).replace(" of each kernel", "")
        for n, c in launches.items()))


def rint_flips(torch, gpu_sess, cpu_sess, frame) -> int:
    """Resized-gray pixels of one frame's pyramid whose whole level (round
    half to even, the fixed chain's entry seam) differs between the card
    and the CPU: the resize matmuls sum in another order on each."""
    from repro_torch.core.detector import _prep_frame
    h, w = frame.shape[:2]
    levels = []
    for sess in (gpu_sess, cpu_sess):
        prog, ph, pw = sess.detector.program_for(h, w)
        gray = _prep_frame(torch.as_tensor(frame).to(sess.device), h, w,
                           ph, pw)
        levels.append([torch.round(g).cpu() for g in prog.pyramid(gray)])
    return sum(int((a != b).sum()) for a, b in zip(*levels))


def check_batched_kernels(torch, np) -> None:
    """Phase 3d: each dense kernel, in each mode, on a batch of
    KERNEL_BATCH frames of every 640x480 level: kernel(stack)[i] must equal
    kernel(frame i) bit for bit (the launch plans pick tiles and CTAs from
    the batch), and the batch its plain version within the limits of
    check_kernels."""
    import repro_torch.core.quant as quant
    import repro_torch.kernels.dense_block_norm as dbn
    import repro_torch.kernels.dense_grad_hist as dgh
    import repro_torch.kernels.fused_hog as fh
    import repro_torch.kernels.svm_matmul as sm

    gw = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")["svm_w"]
    wt32 = torch.from_numpy(gw).to(DEV).reshape(105, 36).T.contiguous()
    wq = quant.quantize_weight_columns(wt32)[0].contiguous()
    rng = np.random.default_rng(3)
    B = KERNEL_BATCH
    errs, checks = {}, 0

    def same(name, fn, x, split=lambda y, i: y[i]):
        """fn on the stack against fn on each frame alone, bit for bit."""
        nonlocal checks
        got = fn(x)
        for i in range(B):
            one = fn(x[i:i + 1].contiguous())
            need(torch.equal(split(got, i), split(one, 0)),
                 f"{name}: kernel(stack)[{i}] != kernel(frame {i}) at "
                 f"{tuple(x.shape)}")
        checks += 1
        return got

    def err(name, got, want, limit):
        e = float((got.float() - want.float()).abs().max())
        need(e <= limit, f"{name} B{B}: max err vs plain {e} > {limit}")
        errs[name] = max(errs.get(name, 0.0), e)

    for H, W in level_shapes(480, 640):
        shape = (B, H, W)
        grays = {"float": torch.from_numpy(
            rng.uniform(0, 255, shape).astype(np.float32)).to(DEV),
                 "fixed": torch.from_numpy(
            rng.integers(0, 256, shape).astype(np.float32)).to(DEV)}
        fused = {}
        for mode, norm in MODE_NORMS.items():
            gray = grays["fixed" if mode == "fixed" else "float"]
            hist = same(f"dense_grad_hist {mode}",
                        lambda g: dgh.dense_grad_hist(g, mode=mode), gray)
            want = dgh.dense_grad_hist_plain(gray, mode=mode)
            if mode == "fixed":
                need(torch.equal(hist, want), "dense_grad_hist fixed B8")
            else:
                need(bool(((hist - want).abs() <= HIST_ATOL
                           + HIST_RTOL * want.abs()).all()),
                     f"dense_grad_hist {mode} B{B} vs plain")
            err(f"dense_grad_hist {mode}", hist, want, math.inf)
            blocks = same(f"dense_block_norm {norm}",
                          lambda h: dbn.dense_block_norm(h, mode=norm), hist)
            want = dbn.dense_block_norm_plain(hist, mode=norm)
            if mode == "fixed":
                flips = code_flips(blocks, want)
                need(flips <= 1e-3 * blocks.numel(),
                     f"dense_block_norm fixed B{B}: {flips} code flips")
                err(f"dense_block_norm {norm}", blocks, want, math.inf)
            else:
                err(f"dense_block_norm {norm}", blocks, want, BLOCK_ATOL)
            fused[mode] = same(f"dense_fused_hog {mode}",
                               lambda g: fh.dense_fused_hog(g, mode=mode),
                               gray)
            need(torch.equal(fused[mode], blocks),
                 f"dense_fused_hog {mode} B{B}: not the pair's blocks")
            want = fh.dense_fused_hog_plain(gray, mode=mode)
            if mode == "fixed":
                need(code_flips(fused[mode], want)
                     <= 1e-3 * want.numel(), "dense_fused_hog fixed B8")
                err(f"dense_fused_hog {mode}", fused[mode], want, math.inf)
            else:
                err(f"dense_fused_hog {mode}", fused[mode], want, BLOCK_ATOL)
        m = fused["cordic"][0].numel() // 36        # block rows a frame
        rows = lambda y, i: y[i * m:(i + 1) * m]     # noqa: E731
        for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            flat = fused["cordic"].reshape(B, m, 36).to(dt)
            wt = wt32.to(dt).contiguous()
            got = same(f"score_matmul {dname}", lambda x: sm.score_matmul(
                x.reshape(-1, 36), wt), flat, rows)
            err(f"score_matmul {dname}", got, sm.score_matmul_plain(
                flat.reshape(-1, 36), wt), MATMUL_ATOL[dname])
        q = quant.quantize_blocks(fused["fixed"].reshape(-1, 36))[0]
        q = q.reshape(B, m, 36)
        got = same("score_matmul_int8 int8", lambda x: sm.score_matmul_int8(
            x.reshape(-1, 36), wq), q, rows)
        err("score_matmul_int8 int8", got, sm.score_matmul_int8_plain(
            q.reshape(-1, 36), wq), 0.0)
    torch.cuda.synchronize()
    by_kernel = {}
    for k, e in errs.items():
        by_kernel.setdefault(k.split()[0], []).append(f"{e:.1e}" if e
                                                      else "0")
    print(f"  batched kernels B{B}, each 640x480 level: kernel(stack)[i] "
          f"== kernel(frame i) in {checks} checks; err vs plain by mode: "
          + ", ".join(f"{k} {'/'.join(v)}" for k, v in by_kernel.items()),
          flush=True)


def _per_kernel(steps, own) -> str:
    """Launches of each kernel in each step ("/" between steps), or, where
    every kernel launched n times in every step, "n of each kernel"."""
    counts = {st[k] for st in steps for k in own}
    if len(counts) == 1:
        return f"{counts.pop()} of each kernel"
    return ", ".join(k + " " + "/".join(str(st[k]) for st in steps)
                     for k in own)


def _autotuned(det_mod, det, B: int) -> str:
    """The chunk the autotune chose for a B-frame batch of this
    detector's configuration on the card, with each candidate's ms."""
    for k, v in det_mod._AUTOTUNE.items():
        if k[4] == B and k[5] == det.cfg and k[10] == "cuda":
            return f"{v['chunk']} (" + " ".join(
                f"{c}:{ms:.2f}" for c, ms in v["probe_ms"].items()) + ")"
    raise SmokeFailure(f"no autotune decision for B {B}")


def batch_path(torch, np, configs, svm) -> dict:
    """Phase 4c: DetectionSession.detect_batch on the card for each dense
    configuration, on batches of 4 and 8 seeded 640x480 scenes and one
    batch of mixed true sizes in the 640x480 bucket, every launch counter
    reset just before each configuration's run and read just after; the
    kept boxes held against the card's single-frame detect and the CPU
    session's detect_batch, scores within SCORE_TOL; ms/frame (host
    clock, configurations in turns), launches and device-busy ms per
    frame, and the idle share."""
    import repro_torch.api as api
    import repro_torch.core.detector as det_mod
    import repro_torch.data.synth_pedestrian as synth
    import repro_torch.kernels as kernels

    batches = {f"B{b}": [synth.make_scene(np.random.default_rng(10 + i),
                                          480, 640, n_people=3)[0]
                         for i in range(b)] for b in BATCH_SIZES}
    batches["mixed"] = [synth.make_scene(np.random.default_rng(30 + i), h,
                                         w, n_people=3)[0]
                        for i, (h, w) in enumerate(MIXED_SIZES)]
    gpu = {n: api.DetectionSession(svm, c, device=DEV)
           for n, (c, _) in configs.items()}
    # the CPU's chunk is fixed: its autotune would run every candidate
    cpu = {n: api.DetectionSession(svm, c.replace(
        detector=dataclasses.replace(c.detector, batch_chunk=1 << 10)),
        device="cpu") for n, (c, _) in configs.items()}
    for sess in gpu.values():                 # the autotune probes first
        for frames in batches.values():
            sess.detect_batch(frames).block_until_ready()

    launches, lines = {}, {}
    for name, sess in gpu.items():
        kernels.reset_launches()
        results, per_batch = {}, []
        for key, frames in batches.items():
            results[key] = sess.detect_batch(frames)
            per_batch.append(kernels.launch_counts())  # running totals
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        launches[f"batch {name}"] = counts
        own = [k for k in counts if k in PATH_KERNELS[f"batch {name}"]]
        for k, n in counts.items():
            need((n > 0) == (k in own), f"batch {name}: kernel {k} "
                 f"launched {n} times")
        steps = [{k: c[k] - p.get(k, 0) for k in own}
                 for p, c in zip([{}] + per_batch, per_batch)]
        dt = configs[name][1]
        n_frames, differ, worst, kept = 0, 0, 0.0, 0
        for key, frames in batches.items():
            got = results[key].to_list()
            # a mixed batch takes each frame's eager gray, edge-padded (as
            # the reference does); its single-frame detect takes the same
            alone = [sess.detect(sess.detector._to_gray(f) if key == "mixed"
                                 else f).to_list() for f in frames]
            for where, ref in (("CPU batch", cpu[name].detect_batch(
                    frames).to_list()), ("card detect", alone)):
                for i, (a, b) in enumerate(zip(got, ref)):
                    first = next((j for j, (x, y) in enumerate(zip(a, b))
                                  if x["box"] != y["box"]), None)
                    need([x["box"] for x in a] == [x["box"] for x in b],
                         f"batch {name} {key} frame {i}: kept boxes differ "
                         f"from the {where}'s ({len(a)} vs {len(b)}; first "
                         f"at {first}: " + (f"{a[first]} vs {b[first]}"
                                            if first is not None else "-")
                         + ")")
                    de = max((abs(x["score"] - y["score"])
                              for x, y in zip(a, b)), default=0.0)
                    need(de <= SCORE_TOL[dt], f"batch {name} {key} frame "
                                              f"{i}: score delta {de}")
                    n_frames += 1
                    differ += de > 0
                    worst = max(worst, de)
            kept += sum(len(a) for a in got)
        need(kept >= 3 * sum(len(f) for f in batches.values()),
             f"batch {name}: only {kept} boxes kept; the check is vacuous")
        lines[name] = (f"{_per_kernel(steps, own)} a batch; = card, CPU:"
                       f" {n_frames} pairs, {kept} boxes, {differ} scores "
                       f"differ (max {worst:.1e})")

    # ms/frame, each batch size, the configurations in turns
    names = list(gpu)
    per_frame = {}
    for b in BATCH_SIZES:
        frames = batches[f"B{b}"]
        total = dict.fromkeys(names, 0.0)
        for rep in range(-1, BATCH_REPS):
            for name in names[rep % len(names):] + names[:rep % len(names)]:
                t0 = time.perf_counter()
                gpu[name].detect_batch(frames).block_until_ready()
                if rep >= 0:
                    total[name] += time.perf_counter() - t0
        for name in names:
            per_frame[(name, b)] = total[name] * 1e3 / (BATCH_REPS * b)
    print("  per batch size: chunk (probe ms per candidate), ms/frame, "
          "frames/s, launches/frame, busy ms/frame, idle share", flush=True)
    for name in names:
        sess = gpu[name]
        text = []
        for b in BATCH_SIZES:
            frames = batches[f"B{b}"]
            times = device_times(
                torch, lambda: sess.detect_batch(frames).block_until_ready(),
                2)
            nl = sum(c for c, _ in times.values()) / 2 / b
            busy = sum(t for _, t in times.values()) / 1e3 / 2 / b
            ms = per_frame[(name, b)]
            text.append(f"B{b} {_autotuned(det_mod, sess.detector, b)} "
                        f"{ms:.3f} {1e3 / ms:.1f} {nl:.0f} {busy:.4f} "
                        f"{1 - busy / ms:.3f}")
        print(f"  batch {name}: " + "; ".join(text) + "; " + lines[name],
              flush=True)

    # the batched resize (f64, one GEMM per axis over the batch, one
    # rounding): pixels unlike each frame's alone and the CPU's; and what
    # f32 GEMMs would give, the batch's shape against each frame's
    det = gpu["paper+kernel"].detector
    prog, ph, pw = det.program_for(480, 640)
    cpu_prog = cpu["paper+kernel"].detector.program_for(480, 640)[0]
    text = []
    for b in BATCH_SIZES:
        stack = torch.from_numpy(np.stack(batches[f"B{b}"])).to(DEV)
        gray = det_mod._prep_batch(stack, 480, 640, ph, pw)
        levels = prog.pyramid(gray)
        on_cpu = cpu_prog.pyramid(gray.cpu())
        f32_wide, f32_alone = [], []
        for sh, sw in [lv.shape[1:] for lv in levels[1:]]:
            wy = torch.tensor(det_mod._resize_weights(ph, sh), device=DEV)
            wx = torch.tensor(det_mod._resize_weights(pw, sw), device=DEV)
            x = wy @ gray.permute(1, 0, 2).reshape(ph, b * pw)
            x = x.reshape(sh, b, pw).permute(1, 0, 2).reshape(b * sh, pw)
            f32_wide.append((x @ wx.T).reshape(b, sh, sw))
            f32_alone.append(torch.stack([(wy @ g) @ wx.T for g in gray]))
        vs_cpu = sum(int((lv.cpu() != c).sum())
                     for lv, c in zip(levels, on_cpu))
        vs_alone = frames_off = pixels = rints = 0
        for i in range(b):
            alone = prog.pyramid(gray[i])
            vs_alone += sum(int((lv[i] != a).sum())
                            for lv, a in zip(levels, alone))
            off = [int((w[i] != a[i]).sum())
                   for w, a in zip(f32_wide, f32_alone)]
            rints += sum(int((torch.round(w[i]) != torch.round(a[i])).sum())
                         for w, a in zip(f32_wide, f32_alone))
            frames_off += any(off)
            pixels += sum(off)
        text.append(f"B{b} {vs_alone}/{vs_cpu}, f32 {frames_off}/{b} "
                    f"({pixels} px, {rints} levels)")
    print("  batched resize (f64), px unlike each frame's/the CPU's, and f32"
          " GEMMs of the batch shape, frames unlike: " + "; ".join(text),
          flush=True)
    return launches


def stream_path(torch, np, configs, svm) -> dict:
    """Phase 4d: DetectionSession.stream of a seeded make_clip clip on the
    card (paper + kernel, batches of 4), counters reset just before and
    read just after; the track ids and boxes must be the CPU session's."""
    import repro_torch.api as api
    import repro_torch.data.synth_pedestrian as synth
    import repro_torch.kernels as kernels

    clip, truths = synth.make_clip(np.random.default_rng(5),
                                   synth.ClipConfig(n_frames=10, h=480,
                                                    w=640, n_people=2))
    cfg = configs["paper+kernel"][0]
    gpu = api.DetectionSession(svm, cfg, device=DEV)
    kernels.reset_launches()
    got = [d.to_list() for d in gpu.stream(list(clip), batch_size=4)]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    own = [k for k in counts if k in PATH_KERNELS["stream paper+kernel"]]
    for k, n in counts.items():
        need((n > 0) == (k in own), f"stream: kernel {k} launched {n} "
                                    f"times")
    cpu = api.DetectionSession(svm, cfg.replace(detector=dataclasses.replace(
        cfg.detector, batch_chunk=1 << 10)), device="cpu")
    want = [d.to_list() for d in cpu.stream(list(clip), batch_size=4)]
    for t, (a, b) in enumerate(zip(got, want)):
        need([(x["track_id"], x["box"]) for x in a]
             == [(x["track_id"], x["box"]) for x in b],
             f"stream frame {t}: tracks differ from the CPU session's")
    ids = sorted({x["track_id"] for a in got for x in a})
    need(len(ids) >= 2, f"stream: only tracks {ids}; the check is vacuous")
    print(f"  stream paper+kernel, {len(clip)} frames of 640x480 in batches "
          f"of 4: {sum(len(a) for a in got)} tracked boxes, track ids "
          f"{ids[0]}-{ids[-1]}, same as CPU; launches: "
          f"{_per_kernel([counts], own)}, others 0", flush=True)
    return {"stream paper+kernel": counts}


def frame_windows(torch, np, svm_np, svm):
    """Workload (b): every 130x66 window at 8-px stride of the three gray
    levels the dense program makes of a seeded 640x480 scene, in the
    program's (level, row, column) order, and the dense score_map
    ("kernel" backend) of each level flattened in the same order."""
    import repro_torch.api as api
    import repro_torch.core.detector as det_mod
    import repro_torch.data.synth_pedestrian as synth
    cfg = api.presets("paper")
    det = det_mod.FrameDetector(svm_np, dataclasses.replace(
        cfg.detector, backend="kernel"), device=DEV)
    frame = synth.make_scene(np.random.default_rng(0), 480, 640,
                             n_people=3)[0]
    prog, ph, pw = det.program_for(480, 640)
    gray = det_mod._prep_frame(torch.as_tensor(frame).to(DEV), 480, 640,
                               ph, pw)
    hcfg = cfg.hog
    wins, dense = [], []
    for level, (_, sph, spw) in zip(prog.pyramid(gray), prog.per_scale):
        grid = level.unfold(0, hcfg.window_h, hcfg.cell).unfold(
            1, hcfg.window_w, hcfg.cell)[:sph, :spw]
        wins.append(grid.reshape(-1, hcfg.window_h, hcfg.window_w))
        dense.append(det_mod.score_map(level, svm["w"], svm["b"], hcfg,
                                       "kernel").reshape(-1))
    wins = torch.cat(wins)
    n = sum(sph * spw for _, sph, spw in prog.per_scale)
    need(wins.shape[0] == n == N_FRAME_WINDOWS,
         f"640x480 gives {wins.shape[0]} windows, per_scale {n}, "
         f"BENCH_detect.json {N_FRAME_WINDOWS}")
    return wins, torch.cat(dense), [sph * spw for _, sph, spw
                                    in prog.per_scale]


def window_path(torch, np) -> dict:
    """Phase 4b: classify_windows on the card per window configuration,
    launch counters reset before each and read after it."""
    import repro_torch.api as api
    import repro_torch.core.pipeline as pipe
    import repro_torch.data.synth_pedestrian as synth
    import repro_torch.kernels as kernels

    g = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")
    svm_np = {"w": g["svm_w"], "b": np.asarray(g["svm_b"], np.float32)}
    svm = {k: torch.from_numpy(v).to(DEV) for k, v in svm_np.items()}
    # workload (a): Table I's 160/134 test split, seeded (the golden
    # weights are seeded random, so no accuracy is read from it)
    split, _ = synth.make_windows(160, 134,
                                       synth.PedestrianDataConfig(),
                                       np.random.default_rng(0))
    need(len(split) == 294, f"the split has {len(split)} windows")
    split_dev = torch.from_numpy(split).to(DEV)
    wins, dense, per_level = frame_windows(torch, np, svm_np, svm)
    torch.cuda.synchronize()

    results, launches = {}, {}
    for name, (preset, path) in WINDOW_CONFIGS.items():
        cfg = api.presets(preset).hog
        kernels.reset_launches()
        results[name] = pipe.classify_windows(svm, split_dev, cfg, path)
        if name == "window paper+kernel":
            frame_scores = torch.cat([
                pipe.classify_windows(svm, wins[i:i + WINDOW_CHUNK], cfg,
                                      path)["score"]
                for i in range(0, len(wins), WINDOW_CHUNK)])
        torch.cuda.synchronize()
        launches[name] = check_launches(name, kernels.launch_counts())
    print("window " + launch_line(launches), flush=True)

    parts = []
    for name, (preset, path) in WINDOW_CONFIGS.items():
        cfg = api.presets(preset).hog
        tol = WINDOW_SCORE_TOL[preset]
        ref = pipe.classify_windows(svm_np, split, cfg, path, device="cpu")
        got = {k: v.cpu() for k, v in results[name].items()}
        need(got["score"].shape == (294,) and bool(
            torch.isfinite(got["score"]).all()), f"{name}: scores")
        de = float((got["score"] - ref["score"]).abs().max())
        need(de <= tol, f"{name}: split score delta {de} > {tol}")
        sure = ref["score"].abs() > tol
        need(torch.equal(got["human"][sure], ref["human"][sure]),
             f"{name}: human differs from the CPU where |score| > {tol}")
        parts.append(f"{name[7:]} {de:.2e} ({tol:g}) {int(sure.sum())} "
                     f"{int(got['human'].sum())}")
    print("  294 split windows, delta vs CPU (tol), human same beyond tol, "
          "humans: " + "; ".join(parts), flush=True)

    # numpy windows without a device go to the card
    out = pipe.classify_windows(svm_np, split[:8], api.presets("perf").hog,
                                "fused")
    need(out["score"].device.type == torch.device(DEV).type,
         "numpy windows did not default to the card")
    d = float((frame_scores - dense).abs().max())
    need(d <= LAYOUT_TOL, f"frame windows vs dense score_map: {d}")
    print(f"  window paper+kernel: all {len(wins)} windows of one 640x480 "
          f"frame (levels {'+'.join(map(str, per_level))}), chunks of "
          f"{WINDOW_CHUNK}: max delta vs the dense score_map {d:.2e} "
          f"(tol {LAYOUT_TOL:g})", flush=True)

    print("  window timing, per batch: host ms, windows/s, launches, device "
          "busy ms (share of host ms), own kernels' device ms", flush=True)
    for name, (preset, path) in WINDOW_CONFIGS.items():
        cfg = api.presets(preset).hog
        own = tuple(f"{k}_kernel" for k in PATH_KERNELS[name])
        parts = []
        for B in WINDOW_TIMING_B:
            x = split_dev[torch.arange(B, device=split_dev.device) % 294]

            def run():
                return pipe.classify_windows(svm, x, cfg, path)

            run()
            torch.cuda.synchronize()
            reps = max(3, min(20, 4096 // B))
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / reps
            times = device_times(torch, run, 3)
            busy = sum(t for _, t in times.values()) / 3e3
            kern = sum(t for k, (_, t) in times.items()
                       if any(o in k for o in own)) / 3e3
            n_launch = sum(c for c, _ in times.values()) / 3
            parts.append(f"B{B} {ms:.4f} {B / ms * 1e3:.0f} {n_launch:.0f} "
                         f"{busy:.4f} ({busy / ms:.3f}) {kern:.4f}")
        print(f"  {name}: " + "; ".join(parts), flush=True)
    return launches


# ------------------------------------------------------------ phase 4e

def _table1_rows(acc) -> str:
    return "/".join(f"{acc[k]:.4f}" for k in (
        "with_person_acc", "without_person_acc", "total_acc"))


def _path_launches(name: str, counts: dict) -> str:
    """Require a train-phase path's own kernels > 0 and every other 0;
    its launches as _per_kernel gives them."""
    for k, n in counts.items():
        need((n > 0) == (k in PATH_KERNELS[name]),
             f"{name}: kernel {k} launched {n} times")
    return _per_kernel([counts], PATH_KERNELS[name])


def train_path(torch, np) -> dict:
    """Phase 4e: Table I on the card at the paper's split in both numerics
    modes (gated as benchmarks/bench_accuracy.py), the card against the
    CPU on the same schedule, the trained SVM through the window kernels,
    then a session trained with a mining round, save / load, and the
    detect CLI's --save / --load round trip; counters reset before each
    path and read after it."""
    import contextlib
    import io
    import tempfile

    import repro_torch.api as api
    import repro_torch.configs.hog_svm as hog_svm
    import repro_torch.core.pipeline as pipe
    import repro_torch.core.svm as tsvm
    import repro_torch.data.synth_pedestrian as synth
    import repro_torch.kernels as kernels
    from repro_torch.core.hog import PAPER_HOG, hog_descriptor
    from repro_torch.data.mining import mine_hard_negatives
    from repro_torch.launch import detect as cli

    bench = json.loads((ROOT / "BENCH_detect.json").read_text())["accuracy"]
    golden_wmax = float(np.abs(np.load(ROOT / "tests" / "golden"
                                       / "hog_golden.npz")["svm_w"]).max())
    modes = {"fp32": (PAPER_HOG, "f32"), "fixed": (hog_svm.QUANT, "int8")}
    tcfg = tsvm.SVMTrainConfig(**TABLE1_TRAIN)
    t0 = time.perf_counter()
    x_tr, y_tr, x_te, y_te = synth.make_dataset()
    need((len(y_tr), len(y_te)) == (6997, 294), "not the paper's split")
    data_s = time.perf_counter() - t0
    xtr, xte = (torch.from_numpy(a).to(DEV) for a in (x_tr, x_te))
    ytr, yte = (torch.from_numpy(a).to(DEV) for a in (y_tr, y_te))
    ytr_cpu = torch.from_numpy(y_tr)
    launches, totals = {}, {}
    print(f"  Table I, make_dataset 4202+2795/160+134 ({data_s:.1f} s), "
          f"{tcfg.steps} steps, neg_weight {tcfg.neg_weight:g}: with/"
          f"without/total (BENCH's CPU rows, n_train {bench['n_train']})",
          flush=True)
    for mode, (hcfg, dt) in modes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f_tr, f_te = hog_descriptor(xtr, hcfg), hog_descriptor(xte, hcfg)
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        steps20 = dataclasses.replace(tcfg, steps=PEGASOS_PROFILE_STEPS)
        idx20 = tsvm.train_schedule(len(y_tr), steps20)
        y_pm1 = ytr.to(torch.float32) * 2.0 - 1.0
        prof = device_times(torch, lambda: tsvm.pegasos(f_tr, y_pm1, idx20,
                                                        steps20), 1)
        per_step = sum(c for c, _ in prof.values()) / PEGASOS_PROFILE_STEPS
        busy_step = sum(t for _, t in prof.values()) / PEGASOS_PROFILE_STEPS
        t0 = time.perf_counter()
        params, losses = tsvm.train_svm(f_tr, ytr, tcfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        need(bool(torch.isfinite(losses).all())
             and bool(torch.isfinite(params["w"]).all()),
             f"Table I {mode}: non-finite loss or weights")
        acc = tsvm.accuracy_table(params, f_te, yte)
        totals[mode] = acc["total_acc"]
        need(acc["total_acc"] >= TABLE1_MIN_TOTAL,
             f"Table I {mode}: total {acc['total_acc']:.4f} < "
             f"{TABLE1_MIN_TOTAL}")
        bench_rows = "/".join(f"{bench[f'{mode}_{k}']:.4f}" for k in (
            "with_person_acc", "without_person_acc", "total_acc"))
        print(f"  table1 {mode} {_table1_rows(acc)} ({bench_rows}); "
              f"extract {extract_s:.2f} s, train {train_s:.2f} s, "
              f"{per_step:.0f} launches, {busy_step:.1f} device us/step",
              flush=True)

        # (b) the card's features on the CPU, the same schedule
        params_cpu, _ = tsvm.train_svm(f_tr.cpu(), ytr_cpu, tcfg)
        rel = float(torch.linalg.vector_norm(params["w"].cpu()
                                             - params_cpu["w"])
                    / torch.linalg.vector_norm(params_cpu["w"]))
        acc_cpu = tsvm.accuracy_table(params_cpu, f_te.cpu(),
                                      torch.from_numpy(y_te))
        f_te_cpu = hog_descriptor(torch.from_numpy(x_te), hcfg)
        off = f_te.cpu() != f_te_cpu
        dmax = float((f_te.cpu() - f_te_cpu).abs().max())
        cpu_line = (f"CPU, same schedule: w rel L2 {rel:.1e}, "
                    f"{_table1_rows(acc_cpu)}; test descriptors off CPU's "
                    f"{int(off.sum())}/{off.numel()} (max {dmax:.1e})")

        # (c) the trained SVM through the window kernels: human equals
        # predict on the ref features beyond the score tolerance, scaled
        # from the golden weights' to these (one code step, or the same
        # f32 order, moves a score in proportion to max |w|)
        want = tsvm.svm_score(params, f_te)
        tol = SCORE_TOL[dt] * float(params["w"].abs().max()) / golden_wmax
        parts = []
        for name, (m, path) in TRAIN_EVAL.items():
            if m != mode:
                continue
            kernels.reset_launches()
            out = pipe.classify_windows(params, xte, hcfg, path)
            torch.cuda.synchronize()
            launches[name] = kernels.launch_counts()
            de = float((out["score"] - want).abs().max())
            need(de <= tol, f"{name}: score delta {de} > {tol}")
            sure = want.abs() > tol
            need(torch.equal(out["human"][sure],
                             (want[sure] > 0).to(torch.int32)),
                 f"{name}: human differs from predict beyond {tol}")
            parts.append(f"{path} {de:.1e} ({int((~sure).sum())} in tol)")
        print(f"    {cpu_line}; kernels: human = predict beyond {tol:.1e}, "
              f"delta " + ", ".join(parts) + "; " + ", ".join(dict.fromkeys(
                  _path_launches(n, launches[n]) for n in TRAIN_EVAL
                  if TRAIN_EVAL[n][0] == mode)), flush=True)
    gap = (totals["fixed"] - totals["fp32"]) * 100
    need(abs(gap) <= TABLE1_MAX_GAP_PTS,
         f"Table I: |fixed - fp32| {abs(gap):.2f} > {TABLE1_MAX_GAP_PTS} pts")
    print(f"  table1 gap fixed-fp32 {gap:+.2f} pts ("
          f"{bench['fixed_vs_fp32_gap_pts']:+.2f}); gate >= "
          f"{TABLE1_MIN_TOTAL}, <= {TABLE1_MAX_GAP_PTS} pts met", flush=True)
    del xtr, f_tr

    # (d) a session trained with one mining round, on the card and on the
    # CPU from the same rng
    base = api.presets("paper")
    cfg = base.replace(detector=dataclasses.replace(base.detector,
                                                    backend="kernel"))
    kernels.reset_launches()
    t0 = time.perf_counter()
    gpu = api.DetectionSession.train(cfg, rng=np.random.default_rng(0),
                                     hard_negative_rounds=1,
                                     mine_scenes=MINE_SCENES, device=DEV)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches["mining paper+kernel"] = kernels.launch_counts()
    own = _path_launches("mining paper+kernel",
                         launches["mining paper+kernel"])
    t0 = time.perf_counter()
    cpu = api.DetectionSession.train(cfg, rng=np.random.default_rng(0),
                                     hard_negative_rounds=1,
                                     mine_scenes=MINE_SCENES, device="cpu")
    cpu_s = time.perf_counter() - t0
    need(gpu.mined_negatives > 0, "mining found no hard negatives")
    need(gpu.mined_negatives == cpu.mined_negatives,
         f"mined {gpu.mined_negatives} crops on the card, "
         f"{cpu.mined_negatives} on the CPU")
    rng = np.random.default_rng(1)
    crops = mine_hard_negatives(gpu.svm, cfg.detector, MINE_SCENES, rng,
                                device=DEV)
    crops_cpu = mine_hard_negatives(
        {k: v.cpu() for k, v in gpu.svm.items()}, cfg.detector, MINE_SCENES,
        np.random.default_rng(1), device="cpu")
    need(crops.shape == crops_cpu.shape and len(crops) > 0,
         f"mining with one SVM: {crops.shape} crops on the card, "
         f"{crops_cpu.shape} on the CPU")
    diff = np.abs(crops.astype(np.int16) - crops_cpu.astype(np.int16))
    need(int(diff.max()) <= 1, f"mined crops differ by {int(diff.max())}")
    rel = float(torch.linalg.vector_norm(gpu.svm["w"].cpu() - cpu.svm["w"])
                / torch.linalg.vector_norm(cpu.svm["w"]))
    print(f"  train paper+kernel 1500+1000, 1 mining round of {MINE_SCENES} "
          f"scenes: {gpu_s:.1f} s (CPU {cpu_s:.1f}); mined "
          f"{gpu.mined_negatives} = CPU; w rel L2 {rel:.2e}; card SVM, "
          f"{MINE_SCENES} scenes: {len(crops)} crops = CPU, "
          f"{int((diff > 0).sum())}/{diff.size} px one code off; {own}",
          flush=True)

    scene = synth.make_scene(np.random.default_rng(2), 480, 640,
                             n_people=3)[0]
    with tempfile.TemporaryDirectory() as d:
        gpu.save(d)
        loaded = api.DetectionSession.load(d, cfg, device=DEV)
        need(torch.equal(loaded.svm["w"], gpu.svm["w"])
             and torch.equal(loaded.svm["b"], gpu.svm["b"]),
             "load(save(svm)) is not the same SVM")
        a = [x["box"] for x in gpu.detect(scene).to_list()]
        b = [x["box"] for x in loaded.detect(scene).to_list()]
        need(a == b and len(a) > 0, f"save/load: kept boxes {len(a)} vs "
                                    f"{len(b)} differ")

        # the detect CLI: --save, then --load skips the train and prints
        # the same detections
        outs = []
        kernels.reset_launches()
        for flag in ("--save", "--load"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--fast", "--scenes", "2", "--backend",
                               "kernel", flag, os.path.join(d, "cli")])
            need(rc == 0, f"detect CLI {flag} exited {rc}")
            outs.append(buf.getvalue().splitlines())
        torch.cuda.synchronize()
        launches["cli kernel"] = kernels.launch_counts()
        cli_own = _path_launches("cli kernel", launches["cli kernel"])
    dets = [[ln.split(" (")[0] if ln.startswith("scene ") else ln
             for ln in out if ln.startswith(("scene ", "   (", "recall"))]
            for out in outs]
    need(dets[0] == dets[1] and len(dets[0]) >= 3,
         "detect CLI: --load printed other detections than --save")
    need(any("loaded SVM params" in ln for ln in outs[1])
         and not any(ln.startswith("training") for ln in outs[1]),
         "detect CLI: --load did not skip the train")
    print(f"  save/load: same w, b, {len(a)} boxes; CLI --fast --scenes 2 "
          f"--backend kernel --save, --load: same {len(dets[0]) - 1} lines, "
          f"train skipped, {dets[0][-1].replace('recall over scenes', 'recall')}"
          f"; {cli_own}", flush=True)
    return launches


# ------------------------------------------------------------ phase 4f

def _client(svc, items, barrier, out, errors):
    """One client thread: submit ``items`` ((kind, key, array); kind
    "window" goes to submit, the rest to submit_frame) back to back, then
    wait on each answer in submission order, recording (kind, key,
    payload, ms from submit to answer). The service answers one bucket's
    frames and the windows in arrival order, so in-order waits time each
    such answer when it lands; waits are bounded."""
    try:
        barrier.wait(timeout=60)
        pend = []
        for kind, key, x in items:
            t0 = time.perf_counter()
            fut = svc.submit(x) if kind == "window" else svc.submit_frame(x)
            pend.append((kind, key, fut, t0))
        for kind, key, fut, t0 in pend:
            payload = fut.get(timeout=300)
            out.append((kind, key, payload,
                        (time.perf_counter() - t0) * 1e3))
    except Exception as exc:                      # reported by the caller
        errors.append(f"{type(exc).__name__}: {exc}")


def run_clients(svc, per_client) -> tuple:
    """Run one client thread per item list at once; returns (answers,
    seconds from the common start to the last answer)."""
    import threading
    barrier = threading.Barrier(len(per_client) + 1)
    out, errors = [], []
    threads = [threading.Thread(target=_client, args=(svc, items, barrier,
                                                      out, errors))
               for items in per_client]
    for t in threads:
        t.start()
    barrier.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=400)
        need(not t.is_alive(), "a serve client hung")
    wall = time.perf_counter() - t0
    need(not errors, f"serve clients failed: {errors}")
    return out, wall


def _pct(xs, q) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs), q))


def serve_traffic(np):
    """Each client's requests, interleaved: SERVE_VGA 640x480 and SERVE_HD
    1280x720 seeded scenes, SERVE_WINDOWS make_windows windows in four
    runs, and the four malformed frames."""
    import repro_torch.data.synth_pedestrian as synth
    from repro_torch.serve.faults import malformed_frame
    per_client = []
    for c in range(SERVE_CLIENTS):
        vga = [("vga", (c, i), synth.make_scene(np.random.default_rng(
            500 + 16 * c + i), 480, 640, n_people=3)[0])
            for i in range(SERVE_VGA)]
        hd = [("hd", (c, i), synth.make_scene(np.random.default_rng(
            600 + 16 * c + i), 720, 1280, n_people=3)[0])
            for i in range(SERVE_HD)]
        wins = synth.make_windows(SERVE_WINDOWS // 2, SERVE_WINDOWS // 2,
                                  synth.PedestrianDataConfig(),
                                  np.random.default_rng(700 + c))[0]
        wins = [("window", (c, i), w) for i, w in enumerate(wins)]
        bad = [("bad", (c, i), malformed_frame(np.random.default_rng(s)))
               for i, s in enumerate(MALFORMED_SEEDS)]
        q = len(wins) // 4
        items = (vga[:2] + wins[:q] + vga[2:3] + hd[:1] + bad[:1]
                 + vga[3:4] + wins[q:2 * q] + bad[1:2] + vga[4:5] + hd[1:]
                 + wins[2 * q:3 * q] + vga[5:6] + bad[2:3] + vga[6:7]
                 + wins[3 * q:] + vga[7:] + bad[3:])
        per_client.append(items)
    return per_client


def serve_path(torch, np, configs, svm) -> dict:
    """Phase 4f: session.serve() on the card for paper + kernel and quant
    (fused), warmed at the 640x480 single and B 8 shapes, under
    SERVE_CLIENTS client threads of mixed traffic, every launch counter
    reset just before and read just after; every accepted request
    answered once, frames equal to the card's single-frame detect bit
    for bit and to the CPU service's boxes, windows to the card's
    classify_windows bit for bit and to the CPU's within tolerance,
    malformed frames erring where the CPU service's do. Then the timing
    (the service and direct detect_batch B 8 in turns), the chaos
    schedule and a degradation episode on paper + kernel."""
    import repro_torch.api as api
    import repro_torch.core.pipeline as pipe
    import repro_torch.kernels as kernels
    from repro_torch.core.cascade import reduced_detector
    from repro_torch.serve.faults import (FaultInjector, FaultSpec,
                                          chaos_specs)
    from repro_torch.serve.resilience import ResilienceConfig

    traffic = serve_traffic(np)
    flat = {(kind, key): x for items in traffic for kind, key, x in items}
    frame_keys = [k for k in flat if k[0] != "window"]
    win_keys = [k for k in flat if k[0] == "window"]
    wins_np = np.stack([flat[k] for k in win_keys])
    launches, sessions, lines = {}, {}, []
    for name, (dense, window) in SERVE_CONFIGS.items():
        cfg, dt = configs[dense]
        preset = WINDOW_CONFIGS[window][0]
        gpu = api.DetectionSession(svm, cfg, device=DEV)
        gpu.warmup([(480, 640), (8, 480, 640)])
        sessions[name] = gpu
        svc = gpu.serve().start()
        kernels.reset_launches()
        answers, _ = run_clients(svc, traffic)
        torch.cuda.synchronize()
        launches[name] = check_launches(name, kernels.launch_counts())
        svc.stop()               # joins the worker, whose counters follow
        stats = dict(svc.stats)  # its answers
        n_frames = sum(len([i for i in c if i[0] != "window"])
                       for c in traffic)
        need(len(answers) == sum(map(len, traffic)),
             f"{name}: {len(answers)} answers to {sum(map(len, traffic))} "
             f"requests")
        need(stats["frame_answers"] == n_frames,
             f"{name}: frame_answers {stats['frame_answers']} != "
             f"{n_frames} accepted")
        got = {(kind, key): p for kind, key, p, _ in answers}
        need(len(got) == len(answers), f"{name}: a request answered twice")

        # the CPU service on the same frames (one wide batch step, so no
        # autotune probe runs on the CPU)
        cpu = api.DetectionSession(svm, cfg.replace(
            detector=dataclasses.replace(cfg.detector,
                                         batch_chunk=1 << 10)),
            device="cpu")
        csvc = cpu.serve().start()
        cres = dict(zip(frame_keys, csvc.detect_frames(
            [flat[k] for k in frame_keys], timeout=600)))
        csvc.stop()
        deltas, boxes = [0.0], 0
        for k in frame_keys:
            p, c = got[k], cres[k]
            need(("error" in p) == ("error" in c),
                 f"{name} {k}: error {p.get('error')!r} on the card, "
                 f"{c.get('error')!r} on the CPU")
            if k[0] == "bad":
                continue
            need("error" not in p, f"{name} {k}: {p.get('error')}")
            want = gpu.detect(flat[k]).to_list()
            need(p["detections"] == want,
                 f"{name} {k}: service detections differ from the card's "
                 f"single-frame detect")
            need([x["box"] for x in want] == [x["box"] for x in
                                               c["detections"]],
                 f"{name} {k}: kept boxes differ from the CPU service's")
            boxes += len(want)
            deltas += [abs(a["score"] - b["score"])
                       for a, b in zip(want, c["detections"])]
        need(boxes >= 3 * n_frames // 2, f"{name}: only {boxes} boxes")
        need(max(deltas) <= SCORE_TOL[dt],
             f"{name}: frame score delta {max(deltas)} > {SCORE_TOL[dt]}")
        n_err = sum("error" in got[k] for k in frame_keys)

        out = pipe.classify_windows(gpu.svm, torch.from_numpy(wins_np).to(
            DEV), cfg.hog, cfg.detector.backend)
        want = out["score"].cpu().numpy()
        score = np.array([got[k]["score"] for k in win_keys])
        human = np.array([got[k]["human"] for k in win_keys])
        need(np.array_equal(score, want.astype(np.float64))
             and np.array_equal(human, out["human"].cpu().numpy()),
             f"{name}: window answers differ from classify_windows on the "
             f"card ({int((score != want).sum())} scores)")
        ref = pipe.classify_windows(svm, wins_np, cfg.hog,
                                    cfg.detector.backend, device="cpu")
        tol = WINDOW_SCORE_TOL[preset]
        wde = float(np.abs(score - ref["score"].numpy()).max())
        need(wde <= tol, f"{name}: window delta vs CPU {wde} > {tol}")
        sure = np.abs(ref["score"].numpy()) > tol
        need(np.array_equal(human[sure], ref["human"].numpy()[sure]),
             f"{name}: human differs from the CPU beyond {tol}")
        per = [_per_kernel([launches[name]], PATH_KERNELS[p])
               for p in (dense, window)]
        lines.append((name, len(answers), stats, max(deltas), wde, n_err,
                      boxes, " / ".join(
                          p.replace(" of each kernel", "") for p in per)))
    print(f"  serve {SERVE_CLIENTS} clients x ({SERVE_VGA}+{SERVE_HD} "
          f"frames, {SERVE_WINDOWS} windows, 4 malformed), answered once "
          f"= card detect / classify_windows bit for bit, CPU boxes; "
          f"launches of each frame / window kernel, others 0: "
          + "; ".join(f"{n[6:]} {a} ({s['frame_batches']}+{s['batches']} "
                      f"batches), {b} boxes, CPU delta {d:.1e}/{w:.1e}, "
                      f"{e} err = CPU, launches {k}"
                      for n, a, s, d, w, e, b, k in lines), flush=True)

    # timing, paper + kernel: the service under SERVE_CLIENTS clients of
    # SERVE_VGA 640x480 frames (open loop) and direct detect_batch B 8 on
    # the same frames, in turns; every batch size warmed first, so no
    # autotune probe falls in a timed run
    gpu = sessions["serve paper+kernel"]
    gpu.warmup([(b, 480, 640) for b in range(1, 9)])
    vga = [[i for i in items if i[0] == "vga"] for items in traffic]
    frames = [x for items in vga for _, _, x in items]
    stacks = [np.stack(frames[i:i + 8]) for i in range(0, len(frames), 8)]
    svc = gpu.serve().start()
    lat, svc_s, direct_s = [], 0.0, 0.0
    for rep in range(-1, SERVE_REPS):             # rep -1 warms up
        for turn in ((0, 1) if rep % 2 else (1, 0)):
            if turn == 0:
                res, wall = run_clients(svc, vga)
                need(all("error" not in p for _, _, p, _ in res),
                     "serve timing: an error")
                if rep >= 0:
                    svc_s += wall
                    lat += [ms for _, _, _, ms in res]
            else:
                t0 = time.perf_counter()
                for st in stacks:
                    gpu.detect_batch(st).to_list()
                if rep >= 0:
                    direct_s += time.perf_counter() - t0
    prof = device_times(torch, lambda: run_clients(svc, vga), 1)
    n = len(frames)
    per_frame = sum(c for c, _ in prof.values()) / n
    busy = sum(t for _, t in prof.values()) / n / 1e3
    wlat, wins_s = [], 0.0
    wtraffic = [[i for i in items if i[0] == "window"] for items in traffic]
    for rep in range(-1, SERVE_REPS):
        res, wall = run_clients(svc, wtraffic)
        if rep >= 0:
            wins_s += wall
            wlat += [ms for _, _, _, ms in res]
    svc.stop()
    wstats = dict(svc.stats)
    svc_fps = n * SERVE_REPS / svc_s
    ms_frame = svc_s * 1e3 / (n * SERVE_REPS)
    print(f"  serve 640x480 paper+kernel, {SERVE_CLIENTS} clients x "
          f"{SERVE_VGA} frames, {SERVE_REPS} reps in turns: "
          f"{svc_fps:.1f} frames/s ({ms_frame:.3f} ms/frame), request p50/"
          f"p99 {_pct(lat, 50):.2f}/{_pct(lat, 99):.2f} ms, occupancy "
          f"{wstats['frame_occupancy']:.3f}, {per_frame:.0f} launches and {busy:.4f} busy ms a "
          f"frame (idle {1 - busy / ms_frame:.3f}); detect_batch B8 "
          f"{n * SERVE_REPS / direct_s:.1f} frames/s "
          f"({direct_s * 1e3 / (n * SERVE_REPS):.3f} ms/frame); windows "
          f"B{gpu.config.service.window_batch}: p50/p99 "
          f"{_pct(wlat, 50):.2f}/{_pct(wlat, 99):.2f} ms, "
          f"{len(wlat) / wins_s:.0f} windows/s, occupancy "
          f"{wstats['occupancy']:.3f}", flush=True)

    # chaos: the standard schedule, one frame a batch so every fault fires
    chaos = frames[:CHAOS_FRAMES]
    base = [gpu.detect(f).to_list() for f in chaos]
    inj = FaultInjector(chaos_specs(), seed=0)
    svc = gpu.serve(faults=inj, frame_batch=1).start()
    res = svc.detect_frames(chaos, timeout=120)
    t0 = time.perf_counter()
    svc.stop()
    stop_s = time.perf_counter() - t0
    cstats = dict(svc.stats)
    fired = sorted({k for _, k in inj.fired})
    need(fired == ["device_loss", "kill_worker", "latency"],
         f"chaos: fired {inj.fired}")
    need(cstats["restarts"] >= 2, f"chaos: {cstats['restarts']} restarts")
    need(cstats["frame_answers"] == len(chaos)
         and [r.get("detections") for r in res] == base,
         "chaos: results differ from the unperturbed run")
    need(stop_s < 15, f"chaos: stop() took {stop_s:.1f} s")

    # degradation: thresholds from this run's unperturbed p99, one frame
    # at a time on a service of one frame a batch
    svc = gpu.serve(frame_batch=1).start()
    for f in chaos:
        svc.detect_frames([f], timeout=60)
    svc.stop()
    p99 = svc.stats["latency_ms"]["p99"]
    spike = max(20.0, 10 * p99)
    inj = FaultInjector((FaultSpec("latency", at_batches=(2, 3, 4, 5),
                                   latency_ms=spike),), seed=0)
    svc = gpu.serve(faults=inj, frame_batch=1, resilience=ResilienceConfig(
        degrade_p99_ms=5 * p99, recover_p99_ms=2.5 * p99, recover_dwell=2,
        latency_window=4)).start()
    cpu = api.DetectionSession(svm, gpu.config, device="cpu")
    red = reduced_detector(cpu.detector)
    rungs, rdelta = [], [0.0]
    for f in chaos:
        r = svc.detect_frames([f], timeout=60)[0]
        rungs.append(r["degraded_mode"])
        if r["degraded_mode"] == "reduced":
            want = red(f)
            need([x["box"] for x in r["detections"]]
                 == [x["box"] for x in want],
                 "degraded: reduced-rung boxes differ from the CPU's")
            rdelta += [abs(a["score"] - b["score"])
                       for a, b in zip(r["detections"], want)]
    need("reduced" in rungs, f"degradation never reached reduced: {rungs}")
    need(max(rdelta) <= SCORE_TOL["f32"], f"reduced delta {max(rdelta)}")
    deadline, extra = time.monotonic() + 60, 0
    while svc.stats["degraded_mode"] != "full":
        need(time.monotonic() < deadline,
             f"never recovered: {svc.stats['ladder']}")
        svc.detect_frames([chaos[0]], timeout=60)
        extra += 1
    # one at a time, as the thresholds were measured: a queue of ten
    # would raise p99 over the degrade line by itself
    res = [svc.detect_frames([f], timeout=60)[0] for f in chaos]
    svc.stop()
    trans = svc.stats["ladder"]["transitions"]
    need([r["degraded_mode"] for r in res] == ["full"] * len(chaos)
         and [r["detections"] for r in res] == base,
         "after recovery: results differ from the unperturbed run")
    print(f"  serve chaos paper+kernel, {len(chaos)} frames one a batch: "
          f"fired {'/'.join(fired)}, {cstats['restarts']} restarts, "
          f"{cstats['retries']} retries, same results, stop {stop_s:.2f} s;"
          f" degradation (p99 {p99:.2f} ms: spike {spike:.1f}, lines "
          f"{5 * p99:.1f}/{2.5 * p99:.1f}): {rungs.count('reduced')} frames "
          f"reduced = CPU reduced_detector (delta {max(rdelta):.1e}), full "
          f"after {extra} more, {trans} transitions, same results",
          flush=True)
    return launches


# ------------------------------------------------------------- phase 5

def smoke_leaves(np, cfg, seed: int) -> dict:
    """The reference's LM parameter tree at ``cfg``'s size as numpy
    arrays, layers stacked on axis 0, with its distributions (normal x
    fan_in^-0.5, x 0.02 for embed and lm_head, ones for the norms), from
    a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    L, D, H, K, hd, Fd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab)

    def dense(shape, std=None):
        x = rng.standard_normal(shape, dtype=np.float32)
        return x * np.float32(std if std else shape[-2] ** -0.5)

    def ones(*shape):
        return np.ones(shape, np.float32)

    attn = {"wq": dense((L, D, H * hd)), "wk": dense((L, D, K * hd)),
            "wv": dense((L, D, K * hd)), "wo": dense((L, H * hd, D))}
    if cfg.qk_norm:
        attn.update(q_norm=ones(L, hd), k_norm=ones(L, hd))
    return {"embed": dense((V, D), 0.02), "final_norm": {"scale": ones(D)},
            "layers": {"ln1": {"scale": ones(L, D)},
                       "ln2": {"scale": ones(L, D)}, "attn": attn,
                       "mlp": {"w_gate": dense((L, D, Fd)),
                               "w_up": dense((L, D, Fd)),
                               "w_down": dense((L, Fd, D))}},
            "lm_head": dense((D, V), 0.02)}


def host_ms(torch, fn, reps: int) -> float:
    """Host milliseconds per call of ``fn`` + synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def lm_path(torch, np) -> dict:
    """Phase 5: LM serving of qwen3-14b. At smoke size (f32, weights
    through lm_params_from_numpy) the card's greedy tokens and logits
    against the CPU port's; at full width and depth (bf16, seeded random
    weights made on the card) generate for every LM_BATCHES prompt with
    the launch counters reset just before and read just after, the same
    tokens on a second run, prefill/decode consistency, and ms per
    prefill and per decode step with the device's share in flash
    attention."""
    import dataclasses as dc

    import repro_torch.kernels as kernels
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.serve.engine import generate

    scfg = dc.replace(get_config(LM_ARCH, smoke=True), dtype=torch.float32)
    leaves = smoke_leaves(np, scfg, 0)
    prompt = np.random.default_rng(1).integers(0, scfg.vocab, (3, 16))
    outs = {}
    for dev in (DEV, "cpu"):
        p = lm_params_from_numpy(leaves, scfg, dev)
        toks = generate(p, scfg, prompt, max_new_tokens=8)
        first, cache = prefill(p, {"tokens": toks[:, :16]}, scfg, 24)
        step, _ = decode_step(p, toks[:, 16:17], cache, scfg)
        outs[dev] = [x.cpu() for x in (toks, first, step)]
    need(torch.equal(outs[DEV][0], outs["cpu"][0]),
         "smoke-size greedy tokens differ between the card and the CPU")
    de = max(float((a.float() - b.float()).abs().max())
             for a, b in zip(outs[DEV][1:], outs["cpu"][1:]))
    need(de <= LM_SMOKE_TOL, f"smoke-size logits card vs CPU: {de}")
    print(f"  lm {LM_ARCH} smoke f32 (lm_params_from_numpy): 3x8 greedy "
          f"tokens same as CPU; prefill and decode logits max delta "
          f"{de:.2e} (tol {LM_SMOKE_TOL:g})", flush=True)

    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n = sum(t.numel() for t in params.parameters())
    need(n == cfg.param_count(), f"{n} parameters, config {cfg.param_count()}")
    rng = np.random.default_rng(2)
    prompts = {g: rng.integers(0, cfg.vocab, (B, S)) for g, B, S in LM_BATCHES}

    kernels.reset_launches()
    toks = {g: generate(params, cfg, x, LM_NEW) for g, x in prompts.items()}
    torch.cuda.synchronize()
    launches = check_launches(f"lm {LM_ARCH}", kernels.launch_counts())
    print(launch_line({f"lm {LM_ARCH}": launches}), flush=True)
    want = cfg.n_layers * len(LM_BATCHES)
    need(launches["flash_attention"] == want,
         f"flash_attention launched {launches['flash_attention']} times in "
         f"{len(LM_BATCHES)} prefills of {cfg.n_layers} layers")
    routes = dict(fa.flash_attention.route_launches)
    need(routes == {"sm90": want, "cuda_core": 0},
         f"bf16 prefills launched the flash routes {routes}, want sm90 "
         f"{want} and cuda_core 0")
    print(f"  lm bf16 prefill flash routes: sm90 {routes['sm90']} "
          f"({cfg.n_layers} per prefill), cuda_core {routes['cuda_core']}",
          flush=True)
    for g, B, S in LM_BATCHES:
        t = toks[g]
        need(t.shape == (B, S + LM_NEW) and bool(((t >= 0)
                                                  & (t < cfg.vocab)).all())
             and torch.equal(t[:, :S].cpu(), torch.from_numpy(prompts[g])),
             f"lm {g}: tokens out of shape or range, or prompt changed")
    g0 = LM_BATCHES[0][0]
    need(torch.equal(generate(params, cfg, prompts[g0], LM_NEW), toks[g0]),
         f"lm {g0}: a second generate gave other tokens")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    x = torch.as_tensor(prompts[g0], device=DEV)
    a, b, rel = decode_consistency(torch, params, cfg, x)
    need(rel["sound"] <= CONSIST_TOL, f"prefill vs prefill + decode_step: "
                                      f"relative L2 {rel} > {CONSIST_TOL}")
    print(f"  lm {LM_ARCH} full width ({cfg.n_layers} layers, {n:,} "
          f"parameters, init {t_init:.1f} s, peak {peak:.2f} GiB): tokens "
          f"in range, rerun same; prefill vs prefill[:-1] + decode_step "
          f"rel L2 {rel['sound']:.2e} (tol "
          f"{CONSIST_TOL:g}; planted: " + _faults(rel) + "), max delta "
          f"{float((a - b).abs().max()):.3f} of max |logit| "
          f"{float(a.abs().max()):.2f}, argmax same in "
          f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{len(a)}",
          flush=True)

    # bounds: matmul (+ causal attention) FLOPs of a prefill at the bf16
    # rate; a decode step reads every weight but the embedding table
    # (B rows of it) and the live cache
    per_token = 2 * (cfg.param_count() - 2 * cfg.vocab * cfg.d_model
                     - cfg.d_model * (2 * cfg.n_layers + 1)
                     - 2 * cfg.hd * cfg.n_layers)
    out = {}
    for g, B, S in LM_BATCHES:
        xg = torch.as_tensor(prompts[g], device=DEV)

        def run_prefill():
            return prefill(params, {"tokens": xg}, cfg, S + LM_NEW)

        ms_prefill = host_ms(torch, run_prefill, 3)
        _, cache = run_prefill()
        tok = xg[:, -1:]

        def run_decode():
            return decode_step(params, tok, cache, cfg)

        ms_decode = host_ms(torch, run_decode, LM_NEW - 1)
        ms_gen = host_ms(torch, lambda: generate(params, cfg, prompts[g],
                                                 LM_NEW), 1)
        pre = device_times(torch, run_prefill, 1)
        dec = device_times(torch, run_decode, 4)
        flash = sum(t for k, (_, t) in pre.items()
                    if "flash_attention_kernel" in k) / 1e3
        busy = sum(t for _, t in pre.values()) / 1e3
        dbusy = sum(t for _, t in dec.values()) / 4e3
        attn_flops = 4 * B * cfg.n_heads * cfg.hd * S * (S + 1) // 2
        bound_pre = (B * S * per_token + 2 * B * cfg.d_model * cfg.vocab
                     + cfg.n_layers * attn_flops) / BF16_FLOPS * 1e3
        kv = 4 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.hd
        bound_dec = (2 * (cfg.param_count() - cfg.vocab * cfg.d_model)
                     + kv) / HBM_BPS * 1e3
        out[g] = dict(prefill_ms=ms_prefill, prefill_bound_ms=bound_pre,
                      prefill_busy_ms=busy, prefill_flash_ms=flash,
                      prefill_launches=sum(c for c, _ in pre.values()),
                      decode_ms=ms_decode, decode_bound_ms=bound_dec,
                      decode_busy_ms=dbusy,
                      decode_launches=sum(c for c, _ in dec.values()) / 4,
                      generate_ms=ms_gen)
        print(f"  lm {g}+{LM_NEW}: prefill {ms_prefill:.2f} ms (bound "
              f"{bound_pre:.2f}; {B * S / ms_prefill * 1e3:.0f} tok/s; "
              f"busy {busy:.2f} ms, flash {flash:.2f} ms = "
              f"{flash / busy:.3f} of it, {out[g]['prefill_launches']} "
              f"launches); decode {ms_decode:.3f} ms/step (bound "
              f"{bound_dec:.3f}; {B / ms_decode * 1e3:.1f} tok/s; busy "
              f"{dbusy:.3f} ms, {out[g]['decode_launches']:.0f} launches); "
              f"generate {ms_gen:.1f} ms", flush=True)

    # the same consistency in f32 at full width and depth, where prefill
    # and decode agree to summation order: the bf16 model goes first
    del params, cache
    torch.cuda.empty_cache()
    cfg = dc.replace(cfg, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    kernels.reset_launches()
    rel = decode_consistency(torch, params, cfg, x)[2]
    r32 = dict(fa.flash_attention.route_launches)
    need(r32 == {"sm90": 0, "cuda_core": 2 * cfg.n_layers},
         f"the f32 prefills launched the flash routes {r32}, want cuda_core "
         f"{2 * cfg.n_layers} and sm90 0")
    faults = min(v for k, v in rel.items() if k != "sound")
    need(rel["sound"] <= CONSIST_TOL_F32 < faults,
         f"f32 prefill vs prefill + decode_step: relative L2 {rel}, limit "
         f"{CONSIST_TOL_F32} (sound under it, planted faults over it)")
    print(f"  lm {LM_ARCH} full width f32 ({4 * n / 1e9:.1f} GB; flash "
          f"cuda_core {r32['cuda_core']}, sm90 {r32['sm90']}): the same "
          f"rel L2 {rel['sound']:.2e} (limit {CONSIST_TOL_F32:g}; planted "
          f"over it: "
          + _faults(rel) + ")", flush=True)
    del params
    torch.cuda.empty_cache()
    return {f"lm {LM_ARCH}": launches}, routes


def decode_consistency(torch, params, cfg, x):
    """The last logits of prefill(x), of prefill(x[:, :-1]) +
    decode_step, and their relative L2 distance for the sound decode and
    for two planted decode faults: RoPE at one position past the token's
    ("pos+1"), and the new key and value written one slot early
    ("kv@idx-1"). Each decode starts from the prefill's cache: the two
    slots a decode can write are put back after it."""
    import repro_torch.models.model as mm

    n = x.shape[1]
    full, _ = mm.prefill(params, {"tokens": x}, cfg, n)
    a = full[:, -1].float()
    _, cache = mm.prefill(params, {"tokens": x[:, :-1]}, cfg, n)
    kept = {t: cache[t][:, :, n - 2:].clone() for t in ("k", "v")}
    sound, rel, b = mm._decode_layer, {}, None
    for name, dpos, didx in (("sound", 0, 0), ("pos+1", 1, 0),
                             ("kv@idx-1", 0, -1)):
        mm._decode_layer = lambda h, lp, c, cl, pos: sound(
            h, lp, c, {**cl, "idx": cl["idx"] + didx}, pos + dpos)
        try:
            step = mm.decode_step(params, x[:, -1:], cache, cfg)[0]
        finally:
            mm._decode_layer = sound
        with torch.inference_mode():
            for t in kept:
                cache[t][:, :, n - 2:] = kept[t]
        rel[name] = float((a - step[:, -1].float()).norm() / a.norm())
        b = step[:, -1].float() if b is None else b
    return a, b, rel


def _faults(rel) -> str:
    return ", ".join(f"{k} {v:.2e}" for k, v in rel.items() if k != "sound")


def ptxas_report(name: str, log) -> str:
    """ptxas's registers of one kernel source, the fewest and most over
    its instantiations, and any spill."""
    lines = log.read_text().splitlines() if log.exists() else []
    regs = [int(ln.split("Used ")[1].split(" registers")[0]) for ln in lines
            if "Used " in ln and " registers" in ln]
    spills = [ln.strip() for ln in lines if "spill" in ln and
              "0 bytes spill stores, 0 bytes spill loads" not in ln]
    span = (f"{min(regs)}-{max(regs)}" if len(set(regs)) > 1
            else str(regs[0]) if regs else "-")
    return f"{name} {span}" + (f" ({'; '.join(spills)})" if spills else "")


def spill_bytes(log):
    """Bytes of spill stores and spill loads over every function in one
    kernel source's ptxas report."""
    st = ld = 0
    for ln in log.read_text().splitlines():
        if "bytes spill stores" in ln:
            parts = ln.split(",")
            st += int(next(p for p in parts if "spill stores" in p).split()[0])
            ld += int(next(p for p in parts if "spill loads" in p).split()[0])
    return st, ld


def sm90_report(build) -> None:
    """flash_attention_sm90 must run on the tensor cores through TMA with
    no spills: count HGMMA and UTMALDG in its SASS (cuobjdump) and read
    ptxas's spill lines; print both, fail on a zero or a spill."""
    lib = build.library_path("flash_attention_sm90")
    lines = lib.with_suffix(".log").read_text().splitlines()
    spills = [ln.strip() for ln in lines if "spill" in ln]
    need(bool(spills) and all(
        "0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
        f"flash_attention_sm90 spills: {spills}")
    cuobjdump = pathlib.Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120)
    need(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-500:]}")
    counts = {op: sass.stdout.count(op) for op in ("HGMMA", "UTMALDG")}
    need(all(counts.values()), f"flash_attention_sm90 SASS: {counts}")
    print(f"flash_attention_sm90 SASS (3 instantiations): HGMMA "
          f"{counts['HGMMA']}, UTMALDG {counts['UTMALDG']}; ptxas: "
          f"{len(spills)} functions, no spills; setmaxnreg 240 consumer / "
          f"24 producer registers", flush=True)


def _r(x):
    return float(f"{x:.4g}") if isinstance(x, float) else x


def compact_mode(v: dict, group: str) -> dict:
    """A non-main mode's entry for the kernels line: its error ("err"),
    code flips ("flips") and the main group's CUDA-event ms per call, to 4
    significant digits (its device, plain, bound and library ms are on
    its check line)."""
    short = {"max_abs_err": "err", "code_flips": "flips"}
    out = {short.get(k, k): _r(d) for k, d in v.items()
           if not isinstance(d, dict)}
    out["ms"] = _r(v[group]["ms"])
    return out


def main() -> int:
    # every run probes the batch schedule: no autotune decision is read
    # from, or written to, a cache file
    os.environ["REPRO_AUTOTUNE_CACHE"] = ""
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
              f"{len(took)} kernels in parallel (each "
              f"{min(took.values(), default=0):.1f}-"
              f"{max(took.values(), default=0):.1f} s)", flush=True)
        reports = [ptxas_report(n, build.library_path(n).with_suffix(".log"))
                   for n in build.SOURCES]
        pair = {n: spill_bytes(build.library_path(n).with_suffix(".log"))
                for n in ("dense_grad_hist", "dense_block_norm",
                          "hog_gradient", "fused_hog")}
        spills = ", ".join(f"{n} {st}/{ld}" for n, (st, ld) in pair.items())
        print("ptxas registers, fewest-most over instantiations: "
              + ", ".join(reports) + "; spill stores/loads, bytes: "
              + (spills if any(map(sum, pair.values()))
                 else "0/0 in " + ", ".join(pair)), flush=True)
        need(not any("spill" in r for r in reports)
             and not any(sum(v) for v in pair.values()), "ptxas spilled")
        sm90_report(build)

        one = torch.zeros(1, device=DEV)
        floor = kernel_device_ms(torch, lambda: one.add_(1), "")
        print("kernel checks vs plain (err: worst shape), per frame or "
              "window batch: device/plain/bound/library ms; launch floor "
              f"(1-element add_): {_fmt(floor)}", flush=True)
        summary = check_kernels(torch, np)
        check_batched_kernels(torch, np)
        summary.update(check_window_kernels(torch, np))
        summary.update(check_flash(torch, np))
        print("main path:", flush=True)
        launches, configs, svm = main_path(torch, np)
        print("batch path:", flush=True)
        launches.update(batch_path(torch, np, configs, svm))
        launches.update(stream_path(torch, np, configs, svm))
        print("window path:", flush=True)
        launches.update(window_path(torch, np))
        print("train path:", flush=True)
        launches.update(train_path(torch, np))
        print("serve path:", flush=True)
        launches.update(serve_path(torch, np, configs, svm))
        print("LM path:", flush=True)
        lm_launches, flash_routes = lm_path(torch, np)
        launches.update(lm_launches)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1

    # launches: the sum of each path's own count (each read right after
    # that path's run), with the per-path counts beside it; the top-level
    # numbers are the main mode's sums at the main group (640x480 for the
    # dense kernels, B = 512 for the window kernels, B 4 x S 512 for
    # flash_attention), to 4 digits; every other mode's error and ms at the
    # main group are under "modes" (every group's device, plain, bound and
    # library ms are on the kernel-check lines above)
    kernels_line = {"kernels": []}
    for k in KERNELS:
        main = summary[k][MAIN_MODE[k]][MAIN_GROUP[k]]
        kernels_line["kernels"].append({
            "name": k, "route": "cuda", "source": KERNELS[k][0],
            "replaces": KERNELS[k][1],
            "launches": sum(c[k] for c in launches.values()),
            "max_abs_err": _r(summary[k]["max_abs_err"]),
            **{key: _r(main[key]) for key in ("ms", "device_ms",
                                              "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
            # the library call's CUDA-event ms, where there is one
            **({"library_call_ms": _r(main["library_call_ms"])}
               if main["library_call_ms"] is not None else {}),
            # the other modes' err (and flips) and ms; the main mode's
            # err is on its check line
            "modes": {m: compact_mode(v, MAIN_GROUP[k])
                      for m, v in summary[k].items()
                      if m not in ("max_abs_err", MAIN_MODE[k])},
            })
    flash = next(e for e in kernels_line["kernels"]
                 if e["name"] == "flash_attention")
    flash["launches_by_route"] = flash_routes
    for m, v in flash["modes"].items():
        v["source"] = FLASH_SOURCES[m]
    print(json.dumps(kernels_line, separators=(",", ":")))
    print(card[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
