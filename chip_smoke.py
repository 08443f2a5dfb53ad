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
     and flash_attention_bwd_sm90's SASS (failing on a zero there);
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
  4i. the tiled path: each dense kernel against its plain version at the
     three levels of a 3840x2160 frame, the slabs a tile computes and a
     batch of 8 level-1.0 frames, in every mode; the uhd preset (banded
     resize, auto-K 954) on one seeded 3840x2160 scene, untiled on the
     card with the "kernel" backend and with perf's and quant's numerics
     on the fused one, counters reset before each and read after: kept
     boxes against the CPU session (near-ties within the tolerance
     allowed to swap, and counted), every banded level equal to the
     CPU's bit for bit, ms/frame, launches, busy ms, n_valid, saturation,
     each dense kernel's device ms a frame and the 954-step NMS alone;
     the same frame tiled over 4 logical devices (REPRO_TEST_DEVICES;
     slab fp 2 and 4, scale fp 2, banded and matmul) equal to the untiled
     card result bit for bit; sharded batches of 7 640x480 scenes (dp =
     the cards, and dp 2 with a pad frame) equal to the paper preset's
     detect_batch bit for bit;
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
     scaled_dot_product_attention (timed only, used nowhere), the
     CUDA-core route in f32 too (beside SDPA in f32, its bound at the f32
     rate); then the query-offset form (one device's chunk of a
     context-parallel prefill, FLASH_CHUNK): both routes in bf16 and
     f32 at every offset and hd against the plain version at the same
     offset, timed at hd 128 beside SDPA with the chunk's boolean mask;
     and its backward at hd 128 (one device's chunk of a context-parallel
     train step): sm90 and cuda_core in bf16, cuda_core in f32, each
     against the plain backward at the same offset, a rerun bit for bit,
     the keys past each chunk zero bit for bit, the four chunks (dk and
     dv summed in f32, dq concatenated) against the whole sequence's
     backward, timed beside SDPA's backward under the chunk's mask;
     then the non-causal chunk (one device's frames of an encoder layer
     over "model", FLASH_ENC_CHUNK: 375 of 1,500 keys, H = K = 20, hd
     64), forward and backward on sm90 in bf16 and cuda_core in f32,
     each against its plain version, reruns bit for bit, the 4 chunks
     against one whole call (outputs concatenated, dk and dv summed in
     f32), timed beside SDPA and the bound; then hymba's chunk (its
     global layers over a (1, 4) row, FLASH_HYMBA_CHUNK: 544 of 2,176
     keys at offsets off the tile grid, H 25, K 5, hd 64), forward and
     backward on sm90 in bf16 against the plain versions at each offset,
     reruns bit for bit, the 4 chunks against one whole call;
     ``--only flash`` runs the build and this phase alone;
  5. LM serving of qwen3-14b: at smoke size in f32 (weights through
     lm_params_from_numpy) the card's greedy tokens and logits against
     the CPU port's; at full width in bf16 with LM_LAYERS (8) of its 40
     layers (seeded random weights made on the card; all 40 run in phase
     5e) generate for 4 prompts of 512 tokens and
     1 of 2,048 (32 new tokens each) with the launch counters reset just
     before and read just after (flash_attention once a layer per prefill,
     all on the sm90 route, no other kernel), the same tokens on a
     second run, prefill against prefill + decode_step (with two
     planted decode faults beside it), and ms per prefill and per decode step with the device's busy time
     and flash attention's share of it; then the same consistency in f32
     (its prefills on the cuda_core route), where the sound
     decode must land under a tight limit and both planted faults over
     it;
  5b. lm families: the MoE, SSM and hybrid families. At smoke size in
     f32 (weights through lm_params_from_numpy) olmoe-1b-7b, mamba2-130m,
     hymba-1.5b and llama4-scout-17b-a16e give the CPU port's greedy
     tokens and logits on the card; at full width in bf16 (seeded random
     weights made on the card) olmoe-1b-7b, mamba2-130m and hymba-1.5b
     (8 of 32 layers; FAMILY_LAYERS; all 32 run in phase 5e) (hymba
     also at B 1 x S 2,048, past its window) generate with the counters
     reset before and read after (flash_attention once per layer without
     a window, on the sm90 route: 16, 0 and 1 a prefill, no other
     kernel), the same tokens on a rerun, parameters = param_count(),
     prefill against prefill + decode_step in bf16 and in f32 with
     planted faults over the f32 limit (the SSM's: a conv window missing
     its newest entry, a state update without the decay), the MoE's
     dropped choices per prefill (checked at a capacity factor where none
     can drop when the configured one drops a last position), and ms,
     bound, busy ms and launches per prefill and decode step, peak GiB;
     then the encoder-decoder and VLM families: whisper-large-v3 and
     qwen2-vl-72b join the smoke f32 line (whisper with seeded frame
     embeddings, qwen2-vl's prompt laid out around an image), and at full
     width in bf16 whisper-large-v3 (8 + 8 of its 32 + 32 layers; B 4,
     1,500 seeded
     frames, a 224-token prompt) generates and qwen2-vl-72b (8 of 80
     layers; B 4 x S 512 "text" and "image" prompts) decodes greedily
     through prefill with (B, S, 3) positions and decode_step: flash sm90
     16 a whisper prefill (8 encoder layers, every key visible, and 8
     decoder layers), 8 a qwen2-vl text prefill and 0 an image one, no
     other kernel; the same checks and numbers as above, the planted
     faults whisper's encoder states of another row and sinusoidal row
     one past, qwen2-vl's h stream one past and kv@idx-1; phase 3c holds
     flash_attention to its plain version at olmoe's, hymba's, whisper's
     encoder (S 1,500, every key visible) and decoder and qwen2-vl's
     prefill shapes too, each with its plain version's and SDPA's device
     ms;
  5c. lm train: the flash backward on its route (sm90 for bf16 at hd 16,
     64 and 128, cuda_core otherwise; one launch of that route a call)
     against its plain version on the card at qwen3-14b's shapes (B 4 x
     S 512, B 1 x S 2,048), hymba's (H 25, K 5, hd 64, S 2,176),
     whisper's encoder (every key visible, S 1,500) and three small ones
     (a ragged S 100 at rep 4 and hd 32; the same at S 300 and hd 64, on
     sm90; every key visible at hd 16), in bf16 (within 3e-2 relative L2)
     and f32 (1e-5), the sm90 route against the cuda_core one (3e-2), the
     sm90 launch plan on standard error, the forward's LSE on either
     route against the plain LSE, a rerun bit for bit, three planted
     faults (delta zero, dK/dV from one head of each GQA group, the
     diagonal key hidden) over the f32 limit on cuda_core and over the
     bf16 limit on sm90, and device (the span of the route's kernels) /
     plain / SDPA-backward ms beside the bound, both bf16 routes at
     qwen3's shapes; qwen3-14b at full width with 4 of its 40 layers in
     bf16 on one lm_data batch of B 4 x S 512: its gradient against the
     same with the plain flash forward and backward (3e-2 relative L2,
     loss 1e-2), then 5 AdamW steps of make_train_step with the counters
     reset just before and read just after (flash forward 8 a step and
     backward 4, both on the sm90 route, no other kernel; loss finite and
     falling), ms a step against its bound, busy
     ms, launches, flash's device ms, peak GiB; every family at smoke
     size in f32, card against CPU (loss 1e-5, gradients 1e-4, one step's
     parameters 1e-5) and a DDP step with int8 compression over 2 logical
     devices; the train CLI in subprocesses at smoke size: SIGTERM, its
     final checkpoint, a resume, the losses of an uninterrupted run;
  5d. lm mesh: on logical devices of the card, serving from weights
     held as shards (init per shard, each piece = the whole init's bit
     for bit; against the same weights whole, the prefill's and every
     step's logits of the same tokens within 3e-2, tokens to a near-tie
     of twice their largest difference, a MoE's expert choices pinned
     to the whole run's where they differ at near-ties, the path counter
     read): olmoe-1b-7b on (2, 4), llama4-scout (8 of 48 layers) and
     qwen3-14b (8 of 40) on (1, 4), qwen3-14b on (2, 2) -- over "model"
     in the reference's layout, context-parallel prefill and
     tensor-parallel decode -- and qwen2-vl-72b (8 of 80 layers) on
     (4, 1), a dp row a device; 16,384 windows over 4
     devices = one device's bit for bit; the ZeRO-3 trainer over
     "model" (olmoe-1b-7b 4L on (2, 2), qwen3-14b 4L on (1, 4), B 4 x S
     512: the gradient against the plain step's at its worst leaf within
     3e-2, the path counter, flash forward and backward launches by
     route, ms a step beside the plain step's and the row path's on the
     same grid), whisper-large-v3 (4 + 4 layers) over "model" on (1, 4)
     and (2, 2) -- encode, prefill and decode steps against the whole
     model, generate(ctx=), flash sm90 one a layer a device of each row,
     then its ZeRO-3 steps as above -- mamba2-130m (24 layers, B 4 x S
     512) and hymba-1.5b (8 of 32 layers, B 1 x S 2,048 + 128 meta
     tokens; B 2 on (2, 2)) over "model" on (1, 4) and (2, 2) (MESH_SSM:
     the context-parallel SSD with its state handed across the devices,
     tensor-parallel decode on each device's state heads; serving as
     above, hymba's global layer one flash launch a device of each row,
     then 3 ZeRO-3 steps as above) -- and gpipe (lm_mesh); ``--only
     lm_mesh`` runs the build and this phase alone;
  5e. lm shapes: phi3-medium-14b, internlm2-20b and command-r-35b at full
     width with 5b's checks (f32 at 32 / 16 layers); then every arch at
     the reference's lengths (configs/registry.py SHAPES) at B 1: prefill
     32,768 (524,288 for mamba2 and hymba, hymba at 8 of its 32 layers
     there), prefill one less and a decode_step against the full cache,
     its logits within 5e-2 of the first prefill's last (a MoE's route
     flips at near-ties pinned); qwen3-14b's train_4k at 4 layers (its
     gradient against the plain flash's, falling loss); classify_windows
     on 16,384 windows through the kernel and fused backends against the
     CPU's scores; each line beside the dry run's predicted peak and
     roofline time (launch/dryrun.py, run in a process of its own from
     the start, with the CPU's window scores; the length cells' lines on
     standard error, a summary on standard output); ``--only lm_shapes`` runs
     the build and this phase alone;
  6. print the kernels line (JSON) and, last, the ok line (JSON).

It imports no JAX and nothing of the reference package. Without a GPU,
or run outside a checkout of the repository, it fails and prints no
result.
"""
from __future__ import annotations

import contextlib
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

# H100 SXM peaks (NVIDIA data sheet; their one copy is
# repro_torch/analysis/roofline.py): HBM bytes/s, f32 CUDA-core FLOP/s (an
# FMA counted as two), dense bf16 tensor-core FLOP/s and int8 tensor-core
# OP/s; a bound is the larger of bytes over the memory rate and operations
# over the peak for their type (each type on its own pipe, so the slowest
# type's time where a kernel mixes them). Outside a checkout main() stops
# before any of them is read.
if (SRC / "repro_torch").is_dir():
    sys.path.insert(0, str(SRC))
    from repro_torch.analysis.roofline import (  # noqa: E402
        F32_FLOPS, HBM_BW as HBM_BPS, INT8_OPS, PEAK_FLOPS as BF16_FLOPS)
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
# stacked heads: the golden SVM and two heads drawn from a numpy seed (with
# the golden weights' spread), their own thresholds; one widened scorer
# launch scores all MH_K at every level (modes "f32x3", "bf16x3", "int8x3")
MH_SEED = 25
MH_SEEDED = {"seeded_a": 0.45, "seeded_b": 0.3}
MH_K = 1 + len(MH_SEEDED)
MH_CONFIGS = ("paper+kernel", "perf", "quant")
MH_BATCH = 8
# the cascade: its preset (golden fine head at THRESHOLD, the "kernel"
# backend) on seeded 640x480 scenes, people 0-3 each; the coarse head
# trained on the card with the reference's schedule (1500 + 1000 windows,
# one mining round of 12 scenes) and repeated step by step on the CPU:
# the windows' descriptors within COARSE_FEAT_TOL, the card's mining round
# the same crops within one code, and Pegasos on the card's features
# step for step on both: w within PEGASOS_TOL relative L2 at every step
# until the active sets first differ, and there only on margins within
# PEGASOS_TIE of the hinge. Pegasos's active set is a threshold on each
# margin (exactly 0 passes 0.5) and its step stays 1.0 for the first
# 1/lam steps, so one such tie (0.0 on the CPU, -2.4e-7 on the card, at
# step 1,011 on an H100 80GB HBM3) parts the runs for good: 3.6e-2
# relative L2 and 0.84 / 0.87 training accuracy at the end, printed, not
# gated (the train phase's heads happened to meet no tie: 7.8e-7)
CASCADE_SEED = 41
COARSE_N = (1500, 1000)        # train_coarse_head's defaults: windows,
COARSE_MINE_SCENES = 12        # mined scenes
CASCADE_SCENES = 12
CASCADE_CPU_SCENES = 4
CASCADE_CLIP = 6
COARSE_FEAT_TOL = 1e-5
PEGASOS_TOL, PEGASOS_TIE = 1e-5, 1e-5
RESILIENT_FRAMES = 10

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
# the families' prefill shapes, bf16 (sm90), (B, S, H, hd) strides: olmoe
# (H 16, K 16, hd 128) at B 4 x S 512 and hymba's global layers (H 25,
# K 5, hd 64) at B 1 x S 2,048 + 128 meta tokens
FLASH_FAMILIES = (("olmoe", 4, 16, 16, 512, 128), ("hymba", 1, 25, 5, 2176, 64))
# and the encoder-decoder's and VLM's (causal last): whisper's encoder
# (H = K = 20, hd 64, every key visible; 1,500 = 11 x 128 + 92, a ragged
# last key tile) and decoder (S 224, ragged) at B 4, qwen2-vl's text
# prompts (H 64, K 8, hd 128) at B 4 x S 512
FLASH_FAMILIES += (("whisper-enc", 4, 20, 20, 1500, 64, False),
                   ("whisper-dec", 4, 20, 20, 224, 64),
                   ("qwen2-vl", 4, 64, 8, 512, 128))
# bf16 kernel vs flash_bf16_matched (the same roundings in f32): (atol,
# rtol); the output's own rounding is 2^-9 relative, and f32 summation
# order can flip a rare p by one bf16 ulp
FLASH_MATCHED_TOL = (2e-3, 2.0 ** -7)
# one device's chunk of a context-parallel prefill (models/attention.py:
# attend_chunk): qwen3-14b's heads, B 1, 512 queries of a 2,048-token
# sequence cut over 4 devices, at each device's offset, against all 2,048
# keys; both routes at each hd the sm90 route is built for, in bf16
# (FLASH_TOL against the plain version) and the CUDA-core route in f32;
# timed at hd 128 at the first and last offsets
FLASH_CHUNK = (1, 40, 8, 512, 2048)          # B, H, K, Sq, Sk
FLASH_CHUNK_OFFSETS = (0, 512, 1024, 1536)
FLASH_CHUNK_HD = (16, 64, 128)
# one device's chunk of a context-parallel encoder layer (whisper's encoder
# over a (1, 4) row): every key visible, B 4, H = K = 20, hd 64, 375 of
# the 1,500 frames against all 1,500 (375 = 2 x 128 + 119 and 1,500 = 11 x
# 128 + 92: both tails ragged); the four chunks against one whole call
FLASH_ENC_CHUNK = (4, 20, 20, 375, 1500, 64)  # B, H, K, Sq, Sk, hd
# one device's chunk of hymba's global layers over a (1, 4) row, as phase
# 5d runs them: 128 meta + 2,048 tokens cut into 544-row chunks, H 25, K
# 5, hd 64; the offsets are off the 128-row tile grid (544 = 4 x 128 +
# 32), so the causal diagonal and the chunk's tail fall inside a tile
FLASH_HYMBA_CHUNK = (1, 25, 5, 544, 2176, 64)  # B, H, K, Sq, Sk, hd
FLASH_HYMBA_OFFSETS = (0, 544, 1088, 1632)
LM_ARCH = "qwen3-14b"
# the earlier LM phases' depths since phase 5e holds every arch at its full
# depth at the reference's lengths (for the run's time): qwen3-14b
# in phase 5 (40 layers before), and by arch in the lm families phase
# (whisper: encoder and decoder layers). The MoE keeps its depth: its
# checks compare routes to a near-tie, and another depth moved a tie over
# the limits (olmoe at 8 layers: prefill vs decode 5.16e-2, and the mesh
# phase's greedy tokens parting at a margin of 0.078)
LM_LAYERS = 8
# hymba and whisper at 8 layers (16 until the offset backward and the
# "model" train step joined phases 3c and 5d), to keep the whole script
# near 12 of its 20 minutes; phase 5e runs both at full depth
FAMILY_LAYERS = {"hymba-1.5b": 8, "whisper-large-v3": 8}
# (group, B, prompt length); each prompt gets LM_NEW new tokens
LM_BATCHES = (("B4xS512", 4, 512), ("B1xS2048", 1, 2048))
LM_GROUPS = tuple(g for g, _, _ in LM_BATCHES)
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
# qwen2-vl's f32 check is held 10x tighter: its planted "mrope-h+1" moves
# the h section, M-RoPE's frequency slots 16-39 (at most 0.032 rad a
# position at hd 128, theta 1e6), and read 7.7e-4 at 8 layers on an H100
# (the sound decode 3.6e-6)
CONSIST_TOL_F32_VLM = 1e-4
LM_SMOKE_TOL = 1e-4      # card vs CPU at smoke size, f32 logits
# the lm families phase: the MoE, SSM and hybrid families at full width in
# bf16 (llama4-scout at smoke size only: about 108 B parameters); hymba
# also at B 1 x S 2,048, whose 2,176 positions (its 128 meta tokens first)
# reach past its 1,024-position window
LM_FAMILIES = ("olmoe-1b-7b", "mamba2-130m", "hymba-1.5b")
LM_SMOKE_ONLY = ("llama4-scout-17b-a16e",)
LM_FAMILY_BATCHES = {"hymba-1.5b": LM_BATCHES}
# smoke prompts longer than hymba's smoke window and meta tokens (16 + 8)
LM_SMOKE_PROMPT = (3, 40)
# the encoder-decoder and VLM families in the same phase. whisper-large-v3
# at full width and depth: B 4, the encoder over encoder_ctx 1,500 seeded
# frame embeddings (30 s of audio), a decoder prompt of 224 tokens
# (n_text_ctx // 2, its longest). qwen2-vl-72b at full width with 8 of its
# 80 layers (19.0 GB of bf16; all 80 need 4 cards), B 4 x S 512 in two
# prompt groups: "text" (t = h = w = arange) and "image" (VLM_IMAGE: 32
# text tokens, a 16 x 16 patch grid at one t, then text, as Qwen2-VL's
# rope index lays them out)
LM_ENCDEC = "whisper-large-v3"
LM_ENCDEC_BATCH = ("B4xS224", 4, 224)
LM_VLM = "qwen2-vl-72b"
LM_VLM_LAYERS = 8
LM_VLM_GROUPS = (("text", 4, 512), ("image", 4, 512))
VLM_IMAGE = (32, 16)             # text tokens before the image, grid side
VLM_SMOKE_IMAGE = (8, 4)
# the lm train phase. The flash backward against its plain version at
# qwen3-14b's two groups (bf16 on both routes and f32; timed), hymba's
# global layers (H 25, K 5, hd 64, 2,176 positions with its meta tokens),
# whisper's encoder (every key visible, S 1,500: a ragged last tile) and
# three small shapes (a ragged S = 100 with rep 4 at hd 32, the cuda_core
# route in both dtypes; the same at S 300 and hd 64, the sm90 route, with
# 4 head groups; every key visible at rep 4 and hd 16), each (name, B, H,
# K, S, hd, causal, dtypes);
# relative L2 limits of the forward's checks; the forward's LSE on either
# route against the plain LSE of the f32 scores (summation order)
BWD_SHAPES = (("B4xS512", 4, 40, 8, 512, 128, True, ("bf16", "f32")),
              ("B1xS2048", 1, 40, 8, 2048, 128, True, ("bf16", "f32")),
              ("hymba", 1, 25, 5, 2176, 64, True, ("bf16",)),
              ("whisper-enc", 4, 20, 20, 1500, 64, False, ("bf16",)),
              ("ragged", 2, 8, 2, 100, 32, True, ("f32", "bf16")),
              ("ragged-sm90", 2, 8, 2, 300, 64, True, ("bf16",)),
              ("small", 2, 8, 2, 64, 16, False, ("f32", "bf16")))
BWD_TOL = {"f32": 1e-5, "bf16": 3e-2}
# where the planted faults are read: f32 on the cuda_core route, bf16 on
# the sm90 one (causal, ragged, rep 4); the shapes that are timed
BWD_FAULT_SHAPES = {"f32": "ragged", "bf16": "ragged-sm90"}
BWD_TIMED = ("B4xS512", "B1xS2048", "hymba", "whisper-enc")
LSE_TOL = 1e-4
# qwen3-14b trained at full width with 4 of its 40 layers (2.88 B
# parameters: bf16 weights and gradients and f32 master, m and v are 46 GB;
# all 40 layers would be 236 GB), B 4 x S 512 of lm_data tokens, 5 AdamW
# steps on that batch at lr 1e-4; its gradient against the same with the
# plain flash forward and backward (bf16 roundings of p and ds elsewhere)
TRAIN_LAYERS = 4
TRAIN_BATCH = (4, 512)
TRAIN_STEPS = 5
TRAIN_LR = 1e-4        # 1e-3 oscillated at full width (13.05 -> 17.98)
TRAIN_GRAD_TOL = 3e-2
TRAIN_LOSS_TOL = 1e-2
# every family at smoke size in f32, card against CPU (summation order);
# S 40 runs past hymba's smoke window and meta tokens
TRAIN_FAMILIES = ("qwen3-14b", "olmoe-1b-7b", "mamba2-130m", "hymba-1.5b",
                  "whisper-large-v3", "qwen2-vl-72b")
TRAIN_SMOKE_BATCH = (2, 40)
TRAIN_SMOKE_TOL = {"loss": 1e-5, "grads": 1e-4, "params": 1e-5}
CLI_STEPS = 30
# the LM meshes, on logical devices of the one card (REPRO_TEST_DEVICES):
# (arch, layers (None: all), grid, B, S, new tokens). olmoe's prefill takes
# the all-to-all EP path (8 shards of 256 tokens, 16 experts an EP
# shard), its decode the replicated one; llama4-scout at 8 of its 48
# layers (39 GB in bf16; all 48 are 216 GB)
MESH_SERVE = (("olmoe-1b-7b", None, (2, 4), 4, 512, 32),
              ("llama4-scout-17b-a16e", 8, (1, 4), 1, 512, 16),
              ("qwen3-14b", 8, (1, 4), 4, 512, 32),
              ("qwen3-14b", 8, (2, 2), 4, 512, 32),
              ("qwen2-vl-72b", 8, (4, 1), 4, 512, 32))
# serving from weights held as shards against the same weights whole:
# bf16 logits (PERF.md's flash limit), and f32 at smoke size, where the
# two differ by the rows' batch sizes and, over "model", by the partial
# sums reduced across the devices
SHARD_TOL, SHARD_TOL_F32 = 3e-2, 1e-6
# 16,384 windows (COPROC_WINDOWS) over this many logical devices
MESH_WINDOWS = 4
MESH_SMOKE_PROMPT = (4, 16)
# the sharded trainer over "model" (context-parallel): olmoe at 4 of its
# 16 layers on (data 2, model 2), qwen3-14b at 4 of its 40 on (1, 4)
MESH_TRAIN = (("olmoe-1b-7b", 4, (2, 2)), ("qwen3-14b", 4, (1, 4)))
# the plan printed beside it: qwen3-14b's whole train state on (4, 1)
MESH_PLAN = ("qwen3-14b", (4, 1))
# whisper-large-v3 over "model" at full width with 4 encoder and 4 decoder
# layers on each grid: B 4 x 224 tokens + 1,500 frames (LM_ENCDEC_BATCH),
# encode, prefill and MESH_ENCDEC_NEW greedy tokens against the whole
# model, then MESH_ENCDEC_STEPS ZeRO-3 steps over "model" (mesh_train)
MESH_ENCDEC = ("whisper-large-v3", 4, ((1, 4), (2, 2)))
MESH_ENCDEC_NEW = 4
MESH_ENCDEC_STEPS = 3
# mamba2-130m at full depth (24 layers), B 4 x S 512, and hymba-1.5b at 8
# of its 32 layers at full width, B 1 x S 2,048 + its 128 meta tokens
# (B 2 on (2, 2): a row a dp row), over "model" on each grid of
# MESH_SSM_GRIDS: serving (mesh_serve: MESH_SSM_NEW greedy tokens), then
# MESH_SSM_STEPS ZeRO-3 steps at the same batch (mesh_train); the
# (arch, layers, B, S) of each
MESH_SSM = (("mamba2-130m", 24, 4, 512), ("hymba-1.5b", 8, 1, 2048))
MESH_SSM_GRIDS = ((1, 4), (2, 2))
MESH_SSM_NEW = 16
MESH_SSM_STEPS = 3
# the archs whose phase 5d lines and launch counts carry their grid
MESH_BY_GRID = ("qwen3-14b", "mamba2-130m", "hymba-1.5b")
# gpipe: 4 full-width qwen3-14b layers over 4 stages, 4 microbatches
MESH_PIPE = (4, 4, 4, 1, 512)        # layers, stages, M, B_mb, S
# phase 5e, lm shapes. (a) The dense configs not yet run at full width, with
# the lm families checks at B 4 x S 512; f32 consistency at a cut depth
# where the f32 weights would not fit the card (internlm2-20b 79.4 GB at
# 48 layers, command-r-35b 121 GB at 40)
LM_DENSE = ("phi3-medium-14b", "internlm2-20b", "command-r-35b")
LM_DENSE_F32_LAYERS = {"internlm2-20b": 32, "command-r-35b": 16}
# (b) the reference's lengths (configs/registry.py SHAPES) at B 1 on one
# card, for every arch where shape_applicable holds: prefill S, then
# prefill S - 1 and one decode_step against the S-row cache, its logits
# held to the prefill's last within CONSIST_TOL. Depths as PERF.md §4
# fixes them (None: all); hymba's windowed layers under the perf profile
# (banded_core): the baseline's masked scores are (1, 25, S, S) f32
SHAPE_LAYERS = {"qwen2-vl-72b": 8, "llama4-scout-17b-a16e": 8}
# hymba at 524,288 with 8 of its 32 layers (its layer 0 global, 7 windowed):
# all 32 took 49 s a prefill on an H100 (peak 67.8 GiB, dry run 67.76)
LONG_LAYERS = {"hymba-1.5b": 8}
SHAPE_PROFILE = {"hymba-1.5b": "perf"}
# train_4k: qwen3-14b at 4 of its 40 layers, B 1 x S 4,096, its gradient
# against the plain flash forward and backward, then AdamW steps
TRAIN_4K = (4, 1, 4096, 3)             # layers, B, S, steps
# hog_svm_coproc: the reference's pod batch of windows on one card
COPROC_WINDOWS = 16384
COPROC_CONFIGS = ("window paper+kernel", "window perf")
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
    # prefill attention without a window takes flash: every olmoe layer,
    # hymba's three global layers; mamba2 attends nowhere
    "lm olmoe-1b-7b": ("flash_attention",),
    "lm hymba-1.5b": ("flash_attention",),
    "lm mamba2-130m": (),
    # whisper: the encoder (every key visible) and the decoder's self
    # attention; qwen2-vl: only where the t stream strictly rises (text),
    # the image prompt's patch block takes _sdpa
    "lm whisper-large-v3": ("flash_attention",),
    "lm qwen2-vl-72b text": ("flash_attention",),
    "lm qwen2-vl-72b image": (),
    # training: the flash forward (twice a layer, remat) and its backward
    "lm train qwen3-14b": ("flash_attention", "flash_attention_bwd"),
    # the meshes: EP serving runs flash in every prefill layer; the sharded
    # trainer and gpipe's backward run the backward too
    "lm mesh olmoe": ("flash_attention",),
    "lm mesh llama4": ("flash_attention",),
    "lm mesh qwen2": ("flash_attention",),
    "lm mesh qwen3 1x4": ("flash_attention",),
    "lm mesh qwen3 2x2": ("flash_attention",),
    # whisper over "model": the encoder's non-causal chunks and the
    # decoder's at their offsets
    "lm mesh whisper 1x4": ("flash_attention",),
    "lm mesh whisper 2x2": ("flash_attention",),
    "lm mesh train": ("flash_attention", "flash_attention_bwd"),
    # the SSM and hybrid families over "model": mamba2 attends
    # nowhere; hymba's global layer takes flash at each chunk's offset
    "lm mesh mamba2 1x4": (),
    "lm mesh mamba2 2x2": (),
    "lm mesh hymba 1x4": ("flash_attention",),
    "lm mesh hymba 2x2": ("flash_attention",),
    "lm mesh train mamba2": (),
    "lm mesh gpipe": ("flash_attention", "flash_attention_bwd"),
    # the dense configs at full width, and the reference's lengths: flash
    # wherever a layer attends without a window; train_4k its backward
    "lm phi3-medium-14b": ("flash_attention",),
    "lm internlm2-20b": ("flash_attention",),
    "lm command-r-35b": ("flash_attention",),
    "lm shapes": ("flash_attention",),
    "lm shapes train_4k": ("flash_attention", "flash_attention_bwd"),
    "coproc paper+kernel": ("hog_gradient", "cell_hist", "block_norm",
                            "svm_scores"),
    "coproc perf": ("fused_hog", "svm_scores"),
}
PATH_KERNELS.update({"mesh windows " + n[7:]: PATH_KERNELS[n]
                     for n in ("window paper+kernel", "window perf")})
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
# stacked heads run their configuration's dense kernels; the cascade (its
# coarse and fine stages) and the resilient service on every rung the
# "kernel" backend's
PATH_KERNELS.update({f"multihead {c}": PATH_KERNELS[c] for c in MH_CONFIGS})
PATH_KERNELS["cascade+kernel"] = PATH_KERNELS["paper+kernel"]
PATH_KERNELS["resilient+kernel"] = PATH_KERNELS["paper+kernel"]
# the tiled path: the uhd preset (banded resize, auto-K) on one seeded
# 3840x2160 scene, untiled on the card (frame_parallel 0 resolves to the
# one card) in three numerics, then tiled over REPRO_TEST_DEVICES logical
# devices on the card, tiles one after another; and sharded batches
UHD_CONFIGS = {"uhd+kernel": ("paper", "kernel", "f32"),
               "uhd perf": ("perf", "fused", "bf16"),
               "uhd quant": ("quant", "fused", "int8")}
PATH_KERNELS.update({n: PATH_KERNELS[{"kernel": "paper+kernel"}.get(
    b, p)] for n, (p, b, _) in UHD_CONFIGS.items()})
PATH_KERNELS["tiled uhd+kernel"] = PATH_KERNELS["paper+kernel"]
PATH_KERNELS["sharded paper+kernel"] = PATH_KERNELS["paper+kernel"]
UHD = (2160, 3840)
UHD_SEED, UHD_PEOPLE = 42, 8
UHD_REPS = 3                   # ms/frame: warm-up, then 3 frames
TILE_DEVICES = 4               # REPRO_TEST_DEVICES of the tiled runs
TILED_CASES = (("slab", 2), ("slab", 4), ("scale", 2))
SHARDED_B, SHARDED_DP = 7, 2   # the pad path: 7 frames over 2 devices
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
    # no TPU kernel: the reference's gradient of attention, the custom VJP
    # of sdpa_flash, is plain JAX
    "flash_attention_bwd": (
        "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
        "src/repro/models/attention.py:359"),
}
# flash_attention's two routes (kernels/flash_attention.py:route), each a
# mode of its entry in the kernels line
FLASH_SOURCES = {"sm90": "src/repro_torch/csrc/flash_attention_sm90.cu",
                 "cuda_core": "src/repro_torch/csrc/flash_attention.cu"}
# flash_attention_bwd's modes: its two routes in bf16, and f32 (cuda_core)
BWD_SOURCES = {"sm90": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
               "cuda_core": "src/repro_torch/csrc/flash_attention_bwd.cu",
               "f32": "src/repro_torch/csrc/flash_attention_bwd.cu"}
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
             "flash_attention": "sm90", "flash_attention_bwd": "sm90"}
MAIN_GROUP = dict.fromkeys(DENSE_KERNELS, "640x480")
MAIN_GROUP.update(dict.fromkeys(WINDOW_KERNELS, "B512"))
MAIN_GROUP["flash_attention"] = MAIN_GROUP["flash_attention_bwd"] = "B4xS512"
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


def level_line(text: str, flush: bool = True) -> None:
    """The per-level and launch-plan lines of the kernel checks (device us
    per level, tiles, CTAs, bands, warps per SM), the scorers' level and
    edge lines, ptxas's register line, the main path's profile and split
    lines and the batched resize's counts go to standard error, to keep
    the standard output under 20 KB."""
    print(text, file=sys.stderr, flush=flush)


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


def device_times(torch, fn, reps: int, warm: bool = True):
    """Run ``fn`` ``reps`` times under torch.profiler; returns {kernel
    name: (launches, device microseconds)} of the CUDA kernels it ran
    (``warm``: ``_profiled``'s warm-up step calls ``fn``)."""
    out = {}
    for e in _profiled(torch, fn, reps, warm).key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = (e.count, float(us))
    return out


def _profiled(torch, fn, reps: int, warm: bool = True):
    """torch.profiler over ``reps`` calls of ``fn``. The profiler traces
    a warm-up step first (one call of ``fn`` unless ``warm`` is false, a
    call that takes seconds, and 64 one-element adds) and discards it:
    late in this script a session without one lost 17-23 of the flash
    backward's 60 kernel records, the first calls' (its sum read 61-71%
    of the CUDA events' time)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    pad = torch.zeros(1, device=DEV)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        if warm:
            fn()
        for _ in range(64):
            pad.add_(1)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return prof


def kernel_span_ms(torch, fn, symbol: str, reps: int = 20):
    """Device milliseconds per call of ``fn`` during which a kernel whose
    name contains ``symbol`` runs: the union of those kernels' intervals
    (torch.profiler), so that kernels running side by side on two streams
    (the sm90 flash backward's dK/dV and dQ) count once; for kernels that
    run one after another it is their sum. None when the profiler saw no
    such kernel; of two sessions the one that recorded more such launches
    counts, as in kernel_device_ms."""
    best = (0, 0.0)
    for _ in range(2):
        spans = sorted(
            (e.time_range.start, e.time_range.end)
            for e in _profiled(torch, fn, reps).events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and symbol in e.name)
        us, end = 0.0, float("-inf")
        for a, b in spans:
            us += max(0.0, b - max(a, end))
            end = max(end, b)
        if len(spans) > best[0]:
            best = (len(spans), us)
    return best[1] / 1e3 / reps if best[1] > 0 else None


def gpu_clocks() -> str:
    """The card's SM and memory clocks (MHz), power draw, temperature and
    active throttle reasons, as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def timing_probe(torch, fn, symbol: str, per_call=None,
                 reps: int = 20) -> str:
    """One line on how two clocks read ``fn``: CUDA events over ``reps``
    back-to-back calls, and torch.profiler's device time of the kernels
    whose name holds ``symbol``, with the launches it recorded (against
    the ``per_call`` x ``reps`` that ran, where ``per_call`` is known) and
    each kernel's share; the card's clocks before and after."""
    before = gpu_clocks()
    ev = cuda_ms(fn, reps=reps)
    times = {k: v for k, v in device_times(torch, fn, reps).items()
             if symbol in k}
    n = sum(c for c, _ in times.values())
    us = sum(t for _, t in times.values())
    split = ", ".join(f"{k.split('(')[0].split()[-1]} {c}x "
                      f"{t / max(c, 1):.0f} us" for k, (c, t) in
                      sorted(times.items()))
    ran = "" if per_call is None else f" of {per_call * reps}"
    return (f"events {ev:.4g} ms; profiler {us / 1e3 / reps:.4g} ms over "
            f"{n}{ran} launches ({split}); clocks "
            f"[{before}] -> [{gpu_clocks()}]")


def kernel_device_ms(torch, fn, symbol: str, reps: int = 20):
    """Device milliseconds per call of ``fn`` spent in kernels whose name
    contains ``symbol`` (torch.profiler; launch gaps excluded), or None
    when the profiler saw no such kernel. A session can lose kernel
    records, never add them (after its warm-up step still 2 of the flash
    backward's 60, or a quarter of an SDPA backward's, now and then), so
    of two sessions the one that recorded more such launches counts."""
    best = (0, 0.0)
    for _ in range(2):
        hit = [(c, t) for k, (c, t) in device_times(torch, fn, reps).items()
               if symbol in k]
        n, us = sum(c for c, _ in hit), sum(t for _, t in hit)
        if n > best[0]:
            best = (n, us)
    return best[1] / 1e3 / reps if best[1] > 0 else None


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
              nbytes, op_s, symbol, flips=None, span=False) -> dict:
    """One kernel at one shape and mode: its error against the plain
    version, and kernel, device, plain, library and bound milliseconds
    (``op_s``: the least seconds of its operations). ``lib_fn`` is one
    PyTorch call of the same function, or None: its ``library_ms`` is
    the device time of every kernel it launches (torch.profiler, as the
    kernel's ``device_ms``), ``library_call_ms`` its CUDA-event time per
    back-to-back call (as the kernel's ``ms``, host dispatch included).
    With ``span`` both device times are kernel_span_ms's (kernels side by
    side on two streams count once)."""
    bound = max(nbytes / HBM_BPS, op_s) * 1e3
    device = kernel_span_ms if span else kernel_device_ms
    lib = call = None
    if lib_fn is not None:
        lib, call = device(torch, lib_fn, ""), cuda_ms(lib_fn)
    return {"kernel": kernel, "frame": where, "shape": list(shape),
            "mode": mode, "max_abs_err": e, "code_flips": flips,
            "ms": cuda_ms(fn),
            "device_ms": device(torch, fn, symbol),
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
    # MH_K stacked heads, head-major columns: the golden head's, then the
    # seeded heads' (36, 105) each
    wt_k = torch.cat([wt32] + [
        torch.from_numpy(h).to(dev).reshape(105, 36).T
        for h in mh_seeded_heads(np, gw)], dim=1).contiguous()
    wq_k, _ = quant.quantize_weight_columns(wt_k)
    wq_k = wq_k.contiguous()
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

        # the widened scorer: MH_K heads in one launch, each head's block
        # equal to its one-head launch bit for bit
        for dname, dt, peak in (("f32", torch.float32, F32_FLOPS),
                                ("bf16", torch.bfloat16, BF16_FLOPS),
                                ("int8", torch.int8, INT8_OPS)):
            x = q if dt == torch.int8 else blocks.to(dt).contiguous()
            wk = wq_k if dt == torch.int8 else wt_k.to(dt).contiguous()
            fn = sm.score_matmul_int8 if dt == torch.int8 else sm.score_matmul
            plain = (sm.score_matmul_int8_plain if dt == torch.int8
                     else sm.score_matmul_plain)
            got = fn(x, wk, MH_K)
            for k in range(MH_K):
                one = fn(x, wk[:, 105 * k:105 * (k + 1)].contiguous())
                need(torch.equal(got[:, 105 * k:105 * (k + 1)], one),
                     f"{fn.__name__} {dname} {shape}: head {k} of "
                     f"{MH_K} is not its one-head launch's")
            wantk = plain(x, wk)
            torch.cuda.synchronize()
            e = float((got.double() - wantk.double()).abs().max())
            need(e == 0 if dt == torch.int8 else e <= MATMUL_ATOL[dname],
                 f"{fn.__name__} {dname}x{MH_K} {shape}: {e}")
            lib = (functools.partial(torch.matmul, x, wk)
                   if dt == torch.float32 else
                   bf16_library(torch, x, wk, wantk, refusals)
                   if dt == torch.bfloat16 else
                   int8_library(torch, x, wk, got, refusals))
            n = 105 * MH_K
            record(fn.__name__, where, (M, 36, n), f"{dname}x{MH_K}", e,
                   functools.partial(fn, x, wk, MH_K),
                   functools.partial(plain, x, wk), lib,
                   x.element_size() * (M * 36 + 36 * n) + 4 * M * n,
                   2 * M * 36 * n / peak, fn.__name__ + "_kernel")
    # 640x480's numbers printed (1280x720's device us are on the level
    # lines below)
    out = summarize(rows, DENSE_KERNELS, ("640x480", "1280x720"), 3,
                    shown=("640x480",))
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
    level_line(f"  dense pair plans ({sms} SMs), tile:CTAs per level ("
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
        level_line(f"  dense pair {mode}/{norm}: " + _by_group(
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
    level_line(f"  dense_fused_hog plan ({sms} SMs), per level: tile "
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
        level_line(f"  dense_fused_hog {mode}: " + _by_group(
            shapes, lambda s: _dev_us(rows, "dense_fused_hog", mode, s))
            + "; " + _by_group(shapes, lambda s: f"{warps[s]:.1f}"),
            flush=True)


def score_levels(torch, rows, shapes) -> None:
    """One line per scorer dtype and width (one head, N = 105; MH_K heads,
    N = 315), level by level: the kernel's device us and the library
    call's (torch.profiler, every kernel it launches; - where the profiler
    saw nothing), and the launch plan's CTAs x rows of the busiest CTA
    (kernels/svm_matmul.py:score_plan)."""
    import repro_torch.kernels.svm_matmul as sm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = list(dict.fromkeys(w for w, _ in shapes))
    for kernel, mode, dt in (("score_matmul", "f32", torch.float32),
                             ("score_matmul", "bf16", torch.bfloat16),
                             ("score_matmul_int8", "int8", torch.int8)):
        for heads, m in ((1, mode), (MH_K, f"{mode}x{MH_K}")):
            text = []
            for g in groups:
                parts = []
                for r in rows:
                    if (r["kernel"], r["mode"], r["frame"]) != (kernel, m,
                                                                g):
                        continue
                    plan = sm.score_plan(r["shape"][0], 105 * heads, dt,
                                         sms, heads=heads)
                    parts.append("/".join(
                        "-" if x is None else f"{x * 1e3:.1f}"
                        for x in (r["device_ms"], r["library_ms"]))
                        + f" {plan.ctas}x{plan.rows}")
                text.append(f"{g[:4]} " + " ".join(parts))
            legend = (f" per level, device/library us, CTAs x rows (x{MH_K}:"
                      f" {MH_K} heads, N {105 * MH_K}, one launch)"
                      if m == "f32" else "")
            level_line(f"  {kernel} {m}{legend}: " + " | ".join(text))


def check_scorer_edges(torch, np) -> None:
    """The scorers against their plain versions where the plan and the
    copies have edges: M = SCORER_TAILS (one to 34 CTAs, a ragged last
    unit), x and w at odd offsets of a flat buffer (the element-wise
    copies), two other widths (a partial int8 word at K = 35; the widest
    head, K = 64 and N = 128), and stacked heads (105 columns a head,
    whose rows stage and store element by element, at odd offsets too;
    8 heads; 128 and 16 columns a head, whose rows take 16-byte copies),
    each head's columns equal to its one-head launch. The 1280x720 levels
    take the shared-memory opt-in above 48 KB."""
    import repro_torch.kernels.svm_matmul as sm
    rng = np.random.default_rng(5)
    worst = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16),
                     ("int8", torch.int8)):
        cases = [(m, 36, 105, False, 1) for m in SCORER_TAILS]
        cases += [(133, 36, 105, True, 1), (4524, 36, 105, True, 1),
                  (133, 35, 50, False, 1), (133, 64, 128, False, 1)]
        # heads: 105 columns a head (strided element copies), at odd
        # offsets too, 8 of them; 128 and 16 a head (16-byte rows)
        cases += [(133, 36, 315, False, 3), (133, 36, 315, True, 3),
                  (4524, 36, 840, False, 8), (133, 36, 256, False, 2),
                  (133, 36, 32, False, 2), (5, 36, 63, False, 3)]
        for M, K, N, odd, heads in cases:
            def draw(n, lo, hi):
                if name == "int8":
                    a = rng.integers(-127, 128, n).astype(np.int8)
                else:
                    a = rng.uniform(lo, hi, n).astype(np.float32)
                buf = torch.from_numpy(a).to(DEV).to(dt)
                return buf[1:] if odd else buf[:n - 1]
            x = draw(M * K + 1, 0, 0.5).view(M, K)
            w = draw(K * N + 1, -0.1, 0.1).view(K, N)
            what = (f"{name} M={M} K={K} N={N} heads={heads}"
                    + (" odd" if odd else ""))
            need((x.data_ptr() % 16 != 0) == odd, f"{what}: alignment")
            fn = sm.score_matmul_int8 if name == "int8" else sm.score_matmul
            if name == "int8":
                got = fn(x, w, heads)
                need(torch.equal(got, sm.score_matmul_int8_plain(x, w)),
                     f"score_matmul_int8 {what}: not equal")
                e = 0.0
            else:
                got = fn(x, w, heads)
                e = float((got - sm.score_matmul_plain(x, w)).abs().max())
                need(e <= MATMUL_ATOL[name], f"score_matmul {what}: {e}")
            nh = N // heads
            for k in range(heads if heads > 1 else 0):
                one = fn(x, w[:, nh * k:nh * (k + 1)].contiguous())
                need(torch.equal(got[:, nh * k:nh * (k + 1)], one),
                     f"{fn.__name__} {what}: head {k} is not its one-head "
                     f"launch's")
            torch.cuda.synchronize()
            worst[name] = max(worst.get(name, 0.0), e)
    level_line(f"  scorer edges (M {'/'.join(map(str, SCORER_TAILS))}; x "
               f"and w at odd offsets, M 133 and 4524; K35xN50; K64xN128; "
               f"heads 3x105 (odd too), 8x105, 2x128, 2x16, 3x21), max err "
               f"vs plain: f32 {worst['f32']:.2e}, bf16 {worst['bf16']:.2e}, "
               f"int8 equal; each head = its one-head launch")


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
    """torch._int_mm on K padded to 40 and N to a multiple of 8 (112, 320:
    its int8 GEMM wants multiples of 8), the padding made outside the
    timing, with the weights
    row-major and, where cuBLASLt refuses that, column-major; None where
    it refuses both. Each reason is printed once."""
    import torch.nn.functional as F
    n8 = -(-wq.shape[1] // 8) * 8
    qp = F.pad(q, (0, 40 - q.shape[1])).contiguous()
    wp = F.pad(wq, (0, n8 - wq.shape[1], 0, 40 - wq.shape[0])).contiguous()
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
                level_line(f"  score_matmul_int8 library: {why}")
            continue
        need(torch.equal(out[:, :want.shape[1]], want),
             "torch._int_mm disagrees with score_matmul_int8")
        return functools.partial(torch._int_mm, qp, w)
    return None


def _sum(rows, key):
    vals = [r[key] for r in rows]
    return None if None in vals else sum(vals)


def _g(x) -> str:
    return "-" if x is None else f"{x:.3g}"


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
    # B 11 is checked (its error is in err) but its times are not printed,
    # nor B 64's here (its device us are on the plan lines below)
    out = summarize(rows, WINDOW_KERNELS, [g for g, _ in WINDOW_BATCHES], 1,
                    shown=("B512",))
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
    level_line(f"  window plans ({sms} SMs), band:CTAs:recompute at B "
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
            level_line(f"  {kernel} {mode}: " + "/".join(dev) + "/"
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
    level_line("  tail plans at B " + "/".join(map(str, sizes)) + ": "
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
        level_line(f"  {kernel} {mode}: " + "/".join(dev) + "/"
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
    level_line(f"  flash_attention {len(FLASH_SMALL)} small shapes + "
          f"{len(FLASH_OTHER_HD)} bf16 at hd 32, each on its route: max err "
          f"vs plain and _sdpa f32 {worst['f32']:.2e} (tol 1e-5), bf16 "
          f"{worst['bf16']:.2e} (tol 3e-2); matched limit share: "
          + ", ".join(f"{r} {x:.2f}" for r, x in ratios.items()),
          flush=True)
    full = []
    for where, B, S in LM_BATCHES:
        H, K, hd = lm.n_heads, lm.n_kv_heads, lm.hd
        arrs = draw(B, H, K, S, hd)
        q32, k32, v32, _, e32, _ = case(arrs, True, "f32", bshd=True)
        q32c, k32c, v32c = (x.contiguous() for x in (q32, k32, v32))
        f32_ms = [kernel_device_ms(torch, fn, sym) for fn, sym in (
            (lambda: fa.launch_cuda_core(q32, k32, v32),
             "flash_attention_kernel"),
            (lambda: fa.flash_attention_plain(q32, k32, v32), ""),
            (lambda: F.scaled_dot_product_attention(
                q32c, k32c, v32c, is_causal=True, enable_gqa=True), ""))]
        f32_bound = max(4 * B * S * (2 * H + 2 * K) * hd / HBM_BPS,
                        4 * B * H * hd * S * (S + 1) // 2 / F32_FLOPS) * 1e3
        level_line(f"  flash_attention cuda_core f32 {where}: device/plain/"
                   f"SDPA f32 ms " + "/".join(_g(t) for t in f32_ms)
                   + f", bound {f32_bound:.4g} (f32 rate)")
        del q32, k32, v32, q32c, k32c, v32c
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
    level_line(f"  flash_attention full width, (B, S, H, hd) strides, err vs "
          f"plain (tol + tol x |want|), matched share: "
          + "; ".join(full), flush=True)
    fam = []
    for name, B, H, K, S, hd, *nc in FLASH_FAMILIES:
        causal = not nc
        q, k, v, got, e, m = case(draw(B, H, K, S, hd), causal, "bf16",
                                  bshd=True)
        need(fa.route(q.dtype, hd) == "sm90", f"{name}: not the sm90 route")
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        dev, plain, lib = (kernel_device_ms(torch, fn, sym) for fn, sym in (
            (lambda: fa.launch_sm90(q, k, v, causal), "flash_attention_kernel"),
            (lambda: fa.flash_attention_plain(q, k, v, causal), ""),
            (lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=causal, enable_gqa=True), "")))
        pairs = S * (S + 1) // 2 if causal else S * S
        bound = max(2 * B * S * (2 * H + 2 * K) * hd / HBM_BPS,
                    4 * B * H * hd * pairs / BF16_FLOPS) * 1e3
        fam.append(f"{name} B{B}xS{S} H{H} K{K} hd{hd}"
                   f"{'' if causal else ' all keys'} {e:.1e} ({m:.2f}) "
                   + "/".join("-" if t is None else f"{t:.4g}"
                              for t in (dev, plain, lib))
                   + f" ({bound:.4g})")
    level_line("  flash_attention sm90 bf16, lm families' prefill shapes and "
               "strides, err (matched share) device/plain/SDPA ms (bound): "
               + "; ".join(fam))
    out = summarize(rows, ("flash_attention",),
                    [g for g, _, _ in LM_BATCHES], 1)
    out["flash_attention"]["max_abs_err"] = max(worst.values())
    out["flash_attention_chunk"] = check_flash_chunks(torch, np)
    out["flash_attention_bwd_chunk"] = check_flash_bwd_chunks(torch, np)
    out["flash_attention_enc_chunk"] = check_flash_enc_chunks(torch, np)
    out["flash_attention_hymba_chunk"] = check_flash_hymba_chunks(torch, np)
    return out


def check_flash_chunks(torch, np) -> dict:
    """Phase 3c, the query-offset form: FLASH_CHUNK's queries at each
    FLASH_CHUNK_OFFSETS offset against the whole sequence's keys, (B, S,
    H, hd) views as prefill hands them; at each FLASH_CHUNK_HD the sm90
    route (bf16, through the wrapper, which must launch it), the
    CUDA-core route in bf16 (launched directly) and in f32, each held to
    flash_attention_plain at the same offset (FLASH_TOL); causal at every
    offset, every key visible at the second. At hd 128 in bf16 and f32,
    at the first and last offsets: device / plain / SDPA ms (SDPA with
    the chunk's boolean mask: its is_causal aligns the diagonal top-left
    when Sq != Sk) and the bound (q read once, k and v once over the
    q_offset + Sq keys the chunk sees, o written once; 4 hd operations a
    visible pair at the type's rate). One line, on standard
    error; -> the errors and times, for the kernels line."""
    import torch.nn.functional as F

    import repro_torch.kernels.flash_attention as fa

    B, H, K, Sq, Sk = FLASH_CHUNK
    rng = np.random.default_rng(9)
    err = {"sm90": 0.0, "cuda_core": 0.0, "f32": 0.0}
    times, n = {}, 0

    def held(got, want, dt, what):
        diff = (got.float() - want.float()).abs()
        lim = FLASH_TOL[dt] * (1 + want.float().abs())
        need(bool((diff <= lim).all()), f"flash_attention {what}: max err "
             f"{float(diff.max())} over {FLASH_TOL[dt]} + {FLASH_TOL[dt]} "
             f"x |want|")
        return float(diff.max())

    for hd in FLASH_CHUNK_HD:
        def draw(S, heads):
            return torch.from_numpy(rng.standard_normal(
                (B, S, heads, hd), dtype=np.float32)).to(DEV).transpose(1, 2)
        k32, v32 = draw(Sk, K), draw(Sk, K)
        for off in FLASH_CHUNK_OFFSETS:
            q32 = draw(Sq, H)
            for causal in (True, False) if off == 512 else (True,):
                what = f"chunk hd{hd} q_offset {off} causal={causal}"
                qb, kb, vb = (x.to(torch.bfloat16) for x in (q32, k32, v32))
                want = fa.flash_attention_plain(qb, kb, vb, causal,
                                                q_offset=off)
                before = dict(fa.flash_attention.route_launches)
                got = fa.flash_attention(qb, kb, vb, causal, q_offset=off)
                torch.cuda.synchronize()
                need(fa.flash_attention.route_launches
                     == {**before, "sm90": before["sm90"] + 1},
                     f"flash_attention {what}: not one sm90 launch")
                err["sm90"] = max(err["sm90"], held(got, want, "bf16",
                                                    what + " sm90"))
                got = fa.launch_cuda_core(qb, kb, vb, causal, q_offset=off)
                err["cuda_core"] = max(err["cuda_core"], held(
                    got, want, "bf16", what + " cuda_core"))
                want = fa.flash_attention_plain(q32, k32, v32, causal,
                                                q_offset=off)
                got = fa.flash_attention(q32, k32, v32, causal,
                                         q_offset=off)
                err["f32"] = max(err["f32"], held(got, want, "f32",
                                                  what + " f32"))
                n += 3
                if hd != 128 or not causal or off not in (
                        FLASH_CHUNK_OFFSETS[0], FLASH_CHUNK_OFFSETS[-1]):
                    continue
                mask = torch.ones(Sq, Sk, dtype=torch.bool,
                                  device=DEV).tril(off)
                pairs = Sq * off + Sq * (Sq + 1) // 2
                for dt, (q, k, v), fn, rate in (
                        ("sm90", (qb, kb, vb), fa.launch_sm90, BF16_FLOPS),
                        ("f32", (q32, k32, v32), fa.launch_cuda_core,
                         F32_FLOPS)):
                    qc, kc, vc = (x.contiguous() for x in (q, k, v))
                    ms = [kernel_device_ms(torch, f, sym) for f, sym in (
                        (lambda: fn(q, k, v, True, q_offset=off),
                         "flash_attention_kernel"),
                        (lambda: fa.flash_attention_plain(q, k, v, True,
                                                          q_offset=off), ""),
                        (lambda: F.scaled_dot_product_attention(
                            qc, kc, vc, attn_mask=mask, enable_gqa=True),
                         ""))]
                    # k and v read over the keys the chunk sees alone
                    seen = min(Sk, off + Sq)
                    nbytes = q.element_size() * B * hd * (2 * Sq * H
                                                          + 2 * seen * K)
                    bound = max(nbytes / HBM_BPS,
                                4 * B * H * hd * pairs / rate) * 1e3
                    times[f"{dt} q{off}"] = ms + [bound]
    line = (f"  flash_attention chunk B{B} H{H} K{K} Sq{Sq} of Sk{Sk} at "
            f"q_offset {'/'.join(map(str, FLASH_CHUNK_OFFSETS))}, hd "
            f"{'/'.join(map(str, FLASH_CHUNK_HD))}, {n} calls: err sm90 "
            f"{err['sm90']:.1e}, cuda_core {err['cuda_core']:.1e} (bf16, tol "
            f"{FLASH_TOL['bf16']:g}), f32 {err['f32']:.1e} (tol "
            f"{FLASH_TOL['f32']:g}); hd128 device/plain/SDPA-mask/bound ms: "
            + "; ".join(f"{k} " + "/".join(_g(t) for t in v)
                        for k, v in times.items()))
    # on standard error: the kernels line carries its numbers
    level_line(line)
    return {"max_abs_err": err, "ms": times}


def check_flash_bwd_chunks(torch, np) -> dict:
    """Phase 3c, the backward's query-offset form: FLASH_CHUNK's queries
    at hd 128 at each FLASH_CHUNK_OFFSETS offset against the whole
    sequence's keys, (B, S, H, hd) views as a context-parallel train step
    hands them, each chunk's forward (with its LSE) at its offset and then
    its backward: bf16 on the sm90 route (through the wrapper, which must
    launch it) and the CUDA-core route (launched directly), f32 on the
    CUDA-core route, each held to flash_attention_bwd_plain at the same
    offset (BWD_TOL, relative L2 of dq, dk and dv); a rerun bit for bit;
    every key past the chunk's last query with zero dk and dv, bit for
    bit; and the chunks together against the whole sequence's backward on
    the same route: dk and dv summed in f32 in chunk order, dq
    concatenated (BWD_TOL). At the first and last offsets: device span /
    plain / SDPA-backward (autograd of scaled_dot_product_attention under
    the chunk's boolean mask) ms and the bound (q, o, do, dq over Sq
    rows, k and v read over the q_offset + Sq keys the chunk sees, dk and
    dv written over Sk rows, the LSE once; five products of 2 hd
    operations a visible pair at the type's rate). One line, on
    standard error; -> the errors and times, for the kernels line."""
    import torch.nn.functional as F

    import repro_torch.kernels.flash_attention as fa

    B, H, K, Sq, Sk = FLASH_CHUNK
    hd = 128
    rng = np.random.default_rng(11)
    arrs = [torch.from_numpy(rng.standard_normal(
        (B, Sk, n, hd), dtype=np.float32)).to(DEV) for n in (H, K, K, H)]
    err = {"sm90": 0.0, "cuda_core": 0.0, "f32": 0.0}
    whole_err = dict(err)
    times, n = {}, 0
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    for dt, modes in ((torch.bfloat16, ("sm90", "cuda_core")),
                      (torch.float32, ("f32",))):
        q, k, v, do = (x.to(dt).transpose(1, 2) for x in arrs)
        out_w, lse_w = fa.flash_attention(q, k, v, True, lse=True)
        for m in modes:
            launch = fa.launch_bwd_cuda_core if m == "cuda_core" \
                else fa.flash_attention_bwd
            whole = launch(q, k, v, out_w, do, lse_w, True)
            dk_sum = torch.zeros(k.shape, dtype=torch.float32, device=DEV)
            dv_sum = torch.zeros_like(dk_sum)
            dqs = []
            for off in FLASH_CHUNK_OFFSETS:
                what = f"flash_attention_bwd chunk {m} q_offset {off}"
                qc, doc = q[:, :, off:off + Sq], do[:, :, off:off + Sq]
                out, lse = fa.flash_attention(qc, k, v, True, lse=True,
                                              q_offset=off)
                r0 = dict(fa.flash_attention_bwd.route_launches)
                got = launch(qc, k, v, out, doc, lse, True, off)
                again = launch(qc, k, v, out, doc, lse, True, off)
                torch.cuda.synchronize()
                if m != "cuda_core":
                    r = "sm90" if m == "sm90" else "cuda_core"
                    need(fa.flash_attention_bwd.route_launches
                         == {**r0, r: r0[r] + 2},
                         f"{what}: not one {r} launch a call")
                need(all(torch.equal(a, b) for a, b in zip(got, again)),
                     f"{what}: a rerun differs")
                want = fa.flash_attention_bwd_plain(qc, k, v, doc, lse, True,
                                                    off)
                e = max(_rel_l2(torch, g, w) for g, w in zip(got, want))
                need(e <= BWD_TOL["f32" if m == "f32" else "bf16"],
                     f"{what}: rel L2 {e} against the plain backward")
                err[m] = max(err[m], e)
                past = [int(torch.count_nonzero(t[:, :, off + Sq:].view(
                    bits[dt]))) for t in got[1:]]
                need(past == [0, 0], f"{what}: {past} nonzero dk / dv bits "
                                     f"at keys past the chunk")
                dqs.append(got[0])
                dk_sum += got[1].float()
                dv_sum += got[2].float()
                n += 1
                if m == "cuda_core" or off not in (
                        FLASH_CHUNK_OFFSETS[0], FLASH_CHUNK_OFFSETS[-1]):
                    continue
                mask = torch.ones(Sq, Sk, dtype=torch.bool,
                                  device=DEV).tril(off)
                ql, kl, vl = (x.detach().contiguous().requires_grad_(True)
                              for x in (qc, k, v))
                out_l = F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=mask, enable_gqa=True)
                pairs = Sq * off + Sq * (Sq + 1) // 2
                # k and v read over the keys the chunk sees, dk and dv
                # written over all Sk (the zeros are output too)
                seen = min(Sk, off + Sq)
                nbytes = q.element_size() * B * hd * (
                    4 * Sq * H + 2 * seen * K + 2 * Sk * K) + 4 * B * H * Sq
                rate = BF16_FLOPS if m == "sm90" else F32_FLOPS
                bound = max(nbytes / HBM_BPS,
                            10 * hd * B * H * pairs / rate) * 1e3
                times[f"{m} q{off}"] = [
                    kernel_span_ms(torch, lambda: launch(
                        qc, k, v, out, doc, lse, True, off),
                        "flash_attention_bwd"),
                    cuda_ms(lambda: fa.flash_attention_bwd_plain(
                        qc, k, v, doc, lse, True, off), reps=5),
                    kernel_span_ms(torch, lambda: torch.autograd.grad(
                        out_l, (ql, kl, vl), doc, retain_graph=True), ""),
                    bound]
            e = max(_rel_l2(torch, g, w) for g, w in zip(
                (torch.cat(dqs, 2), dk_sum, dv_sum), whole))
            need(e <= BWD_TOL["f32" if m == "f32" else "bf16"],
                 f"flash_attention_bwd chunks {m}: summed against the whole "
                 f"sequence's backward, rel L2 {e}")
            whole_err[m] = e
    line = (f"  flash_attention_bwd chunk B{B} H{H} K{K} Sq{Sq} of Sk{Sk} "
            f"hd{hd} at q_offset "
            f"{'/'.join(map(str, FLASH_CHUNK_OFFSETS))}, {n} chunks: rel "
            f"L2 vs plain sm90 {err['sm90']:.1e}, cuda_core "
            f"{err['cuda_core']:.1e} (bf16, tol {BWD_TOL['bf16']:g}), f32 "
            f"{err['f32']:.1e} (tol {BWD_TOL['f32']:g}); chunks summed vs "
            f"whole " + ", ".join(f"{k} {v:.1e}" for k, v in
                                  whole_err.items())
            + "; reruns equal, keys past each chunk zero bit for bit; "
            "device-span/plain/SDPA-bwd-mask/bound ms: "
            + "; ".join(f"{k} " + "/".join(_g(t) for t in v)
                        for k, v in times.items()))
    level_line(line)
    return {"max_abs_err": err, "whole": whole_err, "ms": times}


def check_flash_enc_chunks(torch, np) -> dict:
    """Phase 3c, the non-causal chunk: FLASH_ENC_CHUNK's four chunks of
    queries (an encoder layer over "model", every key visible, Sq < Sk),
    (B, S, H, hd) views as the encoder hands them; bf16 on the sm90 route
    and f32 on the CUDA-core one, each through the wrappers, which must
    launch that route (forward and backward): each chunk's forward held
    to flash_attention_plain (FLASH_TOL) and its backward to
    flash_attention_bwd_plain (BWD_TOL, relative L2 of dq, dk and dv),
    reruns bit for bit, and the chunks together against one whole-sequence
    call on the same route: the outputs concatenated (FLASH_TOL; bit for
    bit or not, printed), dk and dv summed in f32 in chunk order and dq
    concatenated (BWD_TOL). At the first chunk, device (span) / plain /
    SDPA (its backward) ms and the bound: forward, q and o over Sq rows,
    k and v over Sk keys, 4 hd operations a pair; backward, q, o, do and
    dq over Sq rows, k and v read and dk and dv written over Sk, the LSE
    once, 10 hd operations a pair; at the type's rate. One line, on
    standard error; -> the errors and times, for the kernels line."""
    import torch.nn.functional as F

    import repro_torch.kernels.flash_attention as fa

    B, H, K, Sq, Sk, hd = FLASH_ENC_CHUNK
    rng = np.random.default_rng(13)
    arrs = [torch.from_numpy(rng.standard_normal(
        (B, Sk, n, hd), dtype=np.float32)).to(DEV) for n in (H, K, K, H)]
    bounds = [(s, min(s + Sq, Sk)) for s in range(0, Sk, Sq)]
    err, whole_err, times, same = {}, {}, {}, {}
    for dt, m, rate in ((torch.bfloat16, "sm90", BF16_FLOPS),
                        (torch.float32, "f32", F32_FLOPS)):
        r = "sm90" if m == "sm90" else "cuda_core"
        tol, btol = FLASH_TOL["bf16" if m == "sm90" else "f32"], \
            BWD_TOL["bf16" if m == "sm90" else "f32"]
        q, k, v, do = (x.to(dt).transpose(1, 2) for x in arrs)
        out_w, lse_w = fa.flash_attention(q, k, v, False, lse=True)
        whole = fa.flash_attention_bwd(q, k, v, out_w, do, lse_w, False)
        outs, dqs = [], []
        dk = torch.zeros(k.shape, dtype=torch.float32, device=DEV)
        dv = torch.zeros_like(dk)
        err[m] = [0.0, 0.0]
        for s, e in bounds:
            what = f"flash_attention non-causal chunk {m} [{s}, {e})"
            qc, doc = q[:, :, s:e], do[:, :, s:e]
            f0 = dict(fa.flash_attention.route_launches)
            b0 = dict(fa.flash_attention_bwd.route_launches)
            out, lse = fa.flash_attention(qc, k, v, False, lse=True)
            again = fa.flash_attention(qc, k, v, False, lse=True)
            g = fa.flash_attention_bwd(qc, k, v, out, doc, lse, False)
            g2 = fa.flash_attention_bwd(qc, k, v, out, doc, lse, False)
            torch.cuda.synchronize()
            need(fa.flash_attention.route_launches == {**f0, r: f0[r] + 2}
                 and fa.flash_attention_bwd.route_launches
                 == {**b0, r: b0[r] + 2}, f"{what}: not one {r} launch a "
                                          f"call")
            need(torch.equal(out, again[0]) and torch.equal(lse, again[1])
                 and all(torch.equal(a, b) for a, b in zip(g, g2)),
                 f"{what}: a rerun differs")
            want = fa.flash_attention_plain(qc, k, v, False)
            diff = (out.float() - want.float()).abs()
            need(bool((diff <= tol * (1 + want.float().abs())).all()),
                 f"{what}: max err {float(diff.max())} over {tol} + {tol} "
                 f"x |want|")
            want = fa.flash_attention_bwd_plain(qc, k, v, doc, lse, False)
            eb = max(_rel_l2(torch, a, b) for a, b in zip(g, want))
            need(eb <= btol, f"{what}: backward rel L2 {eb} against the "
                             f"plain backward")
            err[m] = [max(err[m][0], float(diff.max())), max(err[m][1], eb)]
            outs.append(out)
            dqs.append(g[0])
            dk += g[1].float()
            dv += g[2].float()
        cat = torch.cat(outs, 2)
        diff = (cat.float() - out_w.float()).abs()
        need(bool((diff <= tol * (1 + out_w.float().abs())).all()),
             f"flash_attention non-causal chunks {m}: concatenated against "
             f"the whole call, max err {float(diff.max())}")
        same[m] = bool(torch.equal(cat, out_w))
        eb = max(_rel_l2(torch, a, b) for a, b in zip(
            (torch.cat(dqs, 2), dk, dv), whole))
        need(eb <= btol, f"flash_attention_bwd non-causal chunks {m}: "
                         f"summed against the whole call, rel L2 {eb}")
        whole_err[m] = [float(diff.max()), eb]
        s, e = bounds[0]
        qc, doc = q[:, :, s:e], do[:, :, s:e]
        out, lse = fa.flash_attention(qc, k, v, False, lse=True)
        qx, kx, vx = (x.detach().contiguous().requires_grad_(True)
                      for x in (qc, k, v))
        sdpa = F.scaled_dot_product_attention(qx, kx, vx, enable_gqa=True)
        el = q.element_size()
        fb = el * B * hd * (2 * (e - s) * H + 2 * Sk * K)
        bb = el * B * hd * (4 * (e - s) * H + 4 * Sk * K) + 4 * B * H * (e - s)
        pairs = B * H * (e - s) * Sk
        times[m] = [
            kernel_device_ms(torch, lambda: fa.flash_attention(
                qc, k, v, False), "flash_attention_kernel"),
            cuda_ms(lambda: fa.flash_attention_plain(qc, k, v, False),
                    reps=5),
            kernel_device_ms(torch, lambda: F.scaled_dot_product_attention(
                qx, kx, vx, enable_gqa=True), ""),
            max(fb / HBM_BPS, 4 * hd * pairs / rate) * 1e3,
            kernel_span_ms(torch, lambda: fa.flash_attention_bwd(
                qc, k, v, out, doc, lse, False), "flash_attention_bwd"),
            cuda_ms(lambda: fa.flash_attention_bwd_plain(
                qc, k, v, doc, lse, False), reps=5),
            kernel_span_ms(torch, lambda: torch.autograd.grad(
                sdpa, (qx, kx, vx), doc, retain_graph=True), ""),
            max(bb / HBM_BPS, 10 * hd * pairs / rate) * 1e3]
    level_line(
        f"  flash_attention non-causal chunks B{B} H{H} K{K} hd{hd}, "
        f"{len(bounds)} x Sq{Sq} of Sk{Sk}: max err / bwd rel L2 vs plain "
        + ", ".join(f"{m} {a:.1e}/{b:.1e}" for m, (a, b) in err.items())
        + "; chunks vs the whole call " + ", ".join(
            f"{m} {a:.1e}/{b:.1e}{' (fwd bit for bit)' if same[m] else ''}"
            for m, (a, b) in whole_err.items())
        + "; reruns equal; chunk 0 fwd device/plain/SDPA/bound, bwd "
        "span/plain/SDPA-bwd/bound ms: " + "; ".join(
            f"{m} " + "/".join(_g(t) for t in v) for m, v in times.items()))
    return {"max_abs_err": err, "whole": whole_err, "ms": times,
            "bit_for_bit": same}


def check_flash_hymba_chunks(torch, np) -> dict:
    """Phase 3c, hymba's chunk: FLASH_HYMBA_CHUNK's queries at each
    FLASH_HYMBA_OFFSETS offset against the whole sequence's keys, causal,
    in bf16, (B, S, H, hd) views as the context-parallel prefill and train
    step hand them, through the wrappers, which must launch the sm90 route
    once a call (forward and backward): each chunk's forward held to
    flash_attention_plain at its offset (FLASH_TOL) and its backward to
    flash_attention_bwd_plain (BWD_TOL, relative L2 of dq, dk and dv),
    reruns bit for bit, and the chunks together against one
    whole-sequence call: the outputs concatenated (FLASH_TOL), dk and dv
    summed in f32 in chunk order and dq concatenated (BWD_TOL). One line,
    on standard error; -> the errors, for the kernels line."""
    import repro_torch.kernels.flash_attention as fa

    B, H, K, Sq, Sk, hd = FLASH_HYMBA_CHUNK
    tol, btol = FLASH_TOL["bf16"], BWD_TOL["bf16"]
    rng = np.random.default_rng(17)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, Sk, n, hd), dtype=np.float32)).to(DEV).to(
        torch.bfloat16).transpose(1, 2) for n in (H, K, K, H))
    out_w, lse_w = fa.flash_attention(q, k, v, True, lse=True)
    whole = fa.flash_attention_bwd(q, k, v, out_w, do, lse_w, True)
    outs, dqs = [], []
    dk = torch.zeros(k.shape, dtype=torch.float32, device=DEV)
    dv = torch.zeros_like(dk)
    err = [0.0, 0.0]
    for off in FLASH_HYMBA_OFFSETS:
        what = f"flash_attention hymba chunk q_offset {off}"
        qc, doc = q[:, :, off:off + Sq], do[:, :, off:off + Sq]
        f0 = dict(fa.flash_attention.route_launches)
        b0 = dict(fa.flash_attention_bwd.route_launches)
        out, lse = fa.flash_attention(qc, k, v, True, lse=True, q_offset=off)
        again = fa.flash_attention(qc, k, v, True, lse=True, q_offset=off)
        g = fa.flash_attention_bwd(qc, k, v, out, doc, lse, True, off)
        g2 = fa.flash_attention_bwd(qc, k, v, out, doc, lse, True, off)
        torch.cuda.synchronize()
        need(fa.flash_attention.route_launches
             == {**f0, "sm90": f0["sm90"] + 2}
             and fa.flash_attention_bwd.route_launches
             == {**b0, "sm90": b0["sm90"] + 2},
             f"{what}: not one sm90 launch a call")
        need(torch.equal(out, again[0]) and torch.equal(lse, again[1])
             and all(torch.equal(a, b) for a, b in zip(g, g2)),
             f"{what}: a rerun differs")
        want = fa.flash_attention_plain(qc, k, v, True, q_offset=off)
        diff = (out.float() - want.float()).abs()
        need(bool((diff <= tol * (1 + want.float().abs())).all()),
             f"{what}: max err {float(diff.max())} over {tol} + {tol} x "
             f"|want|")
        want = fa.flash_attention_bwd_plain(qc, k, v, doc, lse, True, off)
        eb = max(_rel_l2(torch, a, b) for a, b in zip(g, want))
        need(eb <= btol, f"{what}: backward rel L2 {eb} against the plain "
                         f"backward")
        err = [max(err[0], float(diff.max())), max(err[1], eb)]
        outs.append(out)
        dqs.append(g[0])
        dk += g[1].float()
        dv += g[2].float()
    cat = torch.cat(outs, 2)
    diff = (cat.float() - out_w.float()).abs()
    need(bool((diff <= tol * (1 + out_w.float().abs())).all()),
         f"flash_attention hymba chunks: concatenated against the whole "
         f"call, max err {float(diff.max())}")
    eb = max(_rel_l2(torch, a, b) for a, b in zip(
        (torch.cat(dqs, 2), dk, dv), whole))
    need(eb <= btol, f"flash_attention_bwd hymba chunks: summed against the "
                     f"whole call, rel L2 {eb}")
    whole_err = [float(diff.max()), eb]
    level_line(
        f"  flash_attention hymba chunks B{B} H{H} K{K} hd{hd}, Sq{Sq} of "
        f"Sk{Sk} at q_offset {'/'.join(map(str, FLASH_HYMBA_OFFSETS))}, "
        f"sm90 bf16: max err / bwd rel L2 vs plain {err[0]:.1e}/"
        f"{err[1]:.1e} (tol {tol:g} / {btol:g}); chunks vs the whole call "
        f"{whole_err[0]:.1e}/{whole_err[1]:.1e}; reruns equal")
    return {"max_abs_err": err, "whole": whole_err}


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
        level_line(f"  split {key} (paper+kernel), ms: " + ", ".join(
            f"{k[:-3]} {split[k]:.4f}" for k in ("resize_ms", "hog_ms",
                                                "score_matmul_ms",
                                                "collate_ms", "topk_nms_ms"))
                   + f"; launches/frame "
                   f"{split['device_launches_per_frame']:.0f}, busy ms "
                   f"{split['device_busy_ms']:.4f}, ms/frame "
                   f"{split['ms_per_frame']:.4f}")
        text = []
        for name in ("perf", "quant", "quant+kernel"):
            prof = frame_profile(torch, gpu[name], frames[(h, w)][0])
            ms = per_frame[f"{name} {key}"]
            text.append(f"{name} {prof['device_launches_per_frame']:.0f} "
                        f"{prof['device_busy_ms']:.4f} {ms:.4f} "
                        f"{1 - prof['device_busy_ms'] / ms:.4f}")
        legend = (", launches/frame, busy ms, ms/frame, idle"
                  if (h, w) == FRAME_SIZES[0] else "")
        level_line(f"  profile {key}{legend}: " + "; ".join(text))
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
    level_line(f"  batched kernels B{B}, each 640x480 level: kernel(stack)[i] "
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
                f"{c}:{ms:.1f}" for c, ms in v["probe_ms"].items()) + ")"
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
    level_line("  per batch size: chunk (probe ms per candidate), ms/frame, "
               "frames/s, launches/frame, busy ms/frame, idle share")
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
        level_line(f"  batch {name}: " + "; ".join(text) + "; "
                   + lines[name])

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
    level_line("  batched resize (f64), px unlike each frame's/the CPU's, and "
               "f32 GEMMs of the batch shape, frames unlike: "
               + "; ".join(text))
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
    level_line(f"  stream paper+kernel, {len(clip)} frames of 640x480 in batches "
          f"of 4: {sum(len(a) for a in got)} tracked boxes, track ids "
          f"{ids[0]}-{ids[-1]}, same as CPU; launches: "
          f"{_per_kernel([counts], own)}, others 0", flush=True)
    return {"stream paper+kernel": counts}


def mh_seeded_heads(np, gw):
    """The multihead phase's seeded heads: (3780,) f32 each, drawn from
    MH_SEED with the golden weights' spread."""
    rng = np.random.default_rng(MH_SEED)
    return [rng.normal(0, float(np.std(gw)), gw.shape).astype(np.float32)
            for _ in MH_SEEDED]


def _raw(torch, d):
    return (d._scores, d._index, d._keep, torch.as_tensor(d._n_valid).cpu())


def multihead_path(torch, np, configs, svm) -> dict:
    """Phase 4g: MH_K stacked heads (the golden SVM and the seeded ones, a
    HeadRegistry with per-head thresholds) through DetectionSession on the
    card in each MH_CONFIGS configuration, one 640x480 and one 1280x720
    frame and a batch of MH_BATCH of each (one step: batch_chunk above
    the batch), counters reset just before and read just after: the
    widened scorer launched once per level for all heads; each head's
    scores, indices, keep mask and count equal to that head's own
    detector on the card bit for bit; kept boxes with class ids equal to
    the CPU session's, scores within SCORE_TOL."""
    import repro_torch.api as api
    import repro_torch.data.synth_pedestrian as synth
    import repro_torch.kernels as kernels
    from repro_torch.core.detector import FrameDetector
    from repro_torch.core.heads import HeadRegistry

    reg = HeadRegistry()
    reg.add("person", svm, threshold=THRESHOLD)
    for (name, thr), w in zip(MH_SEEDED.items(),
                              mh_seeded_heads(np, svm["w"])):
        reg.add(name, {"w": w, "b": np.float32(0.0)}, threshold=thr)
    frames = {hw: [synth.make_scene(np.random.default_rng(60 + i), *hw,
                                    n_people=3)[0] for i in range(MH_BATCH)]
              for hw in FRAME_SIZES}
    launches, text = {}, []
    for cname in MH_CONFIGS:
        base, dt = configs[cname]
        cfg = base.replace(detector=dataclasses.replace(
            base.detector, batch_chunk=1 << 10))
        name = f"multihead {cname}"
        gpu = api.DetectionSession(reg, cfg, device=DEV)
        dcfg = gpu.detector.cfg
        kernels.reset_launches()
        got = {hw: (gpu.detect(fs[0]), gpu.detect_batch(fs))
               for hw, fs in frames.items()}
        torch.cuda.synchronize()
        launches[name] = check_launches(name, kernels.launch_counts())
        scorer = "score_matmul_int8" if dt == "int8" else "score_matmul"
        need(launches[name][scorer] == 3 * 2 * len(frames),
             f"{name}: {launches[name][scorer]} scorer launches for "
             f"{2 * len(frames)} frames or batches of 3 levels")
        # each head alone on the card: bit for bit
        for k, (hname, thr) in enumerate(zip(gpu.detector.classes,
                                             dcfg.class_thresholds)):
            one = FrameDetector(reg.single(hname), dataclasses.replace(
                dcfg, score_threshold=thr, class_thresholds=()), DEV)
            for hw, fs in frames.items():
                for mine, theirs in ((got[hw][0], one.detect_raw(fs[0])),
                                     (got[hw][1],
                                      one.detect_batch_raw(fs))):
                    need(all(torch.equal(a, b) for a, b in zip(
                        _raw(torch, mine.for_class(k)),
                        _raw(torch, theirs))),
                         f"{name} {hw}: head {hname} is not its own "
                         f"detector's bit for bit")
        # the CPU session: kept boxes by class, scores within SCORE_TOL
        cpu = api.DetectionSession(reg, cfg, device="cpu")
        kept, worst = [], 0.0
        for hw, fs in frames.items():
            want = [cpu.detect(fs[0]).to_list()] + \
                cpu.detect_batch(fs).to_list()
            for i, (a, b) in enumerate(zip(
                    [got[hw][0].to_list()] + got[hw][1].to_list(), want)):
                # each head's boxes in its order (the merge across heads
                # orders by score, and scores agree within SCORE_TOL only)
                for k in range(MH_K):
                    ak = [x for x in a if x["class_id"] == k]
                    bk = [x for x in b if x["class_id"] == k]
                    need([x["box"] for x in ak] == [x["box"] for x in bk],
                         f"{name} {hw} frame {i} head {k}: kept boxes "
                         f"differ from the CPU session's ({len(ak)} vs "
                         f"{len(bk)})")
                    worst = max([worst] + [abs(x["score"] - y["score"])
                                           for x, y in zip(ak, bk)])
            per = [sum(x["class_id"] == k for x in want[0])
                   for k in range(MH_K)]
            kept.append("+".join(map(str, per))
                        + f" ({sum(len(x) for x in want[1:])})")
        need(worst <= SCORE_TOL[dt], f"{name}: score delta {worst}")
        text.append(f"{cname} {' / '.join(kept)} d {worst:.1e}, "
                    f"{launches[name][scorer]} {scorer}")
    level_line(f"  multihead K={MH_K} (person {THRESHOLD:g}, " + ", ".join(
        f"{n} {t:g}" for n, t in MH_SEEDED.items())
        + "), frame + B8, 640x480/1280x720: heads = own detectors bit for "
        "bit; kept by head (B8) = CPU, delta, scorer launches: "
        + "; ".join(text), flush=True)
    return launches


def _iou(a, b) -> float:
    y0, x0 = max(a[0], b[0]), max(a[1], b[1])
    y1, x1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, y1 - y0) * max(0.0, x1 - x0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
    return inter / (ua - inter + 1e-9)


def _same_dets(a, b, what: str) -> float:
    """Kept boxes (and class ids, stages) equal, in order; returns the
    worst score delta."""
    key = (lambda d: (d.get("class_id"), d.get("stage"), d["box"]))
    need([key(x) for x in a] == [key(x) for x in b],
         f"{what}: kept boxes differ ({len(a)} vs {len(b)})")
    return max([0.0] + [abs(x["score"] - y["score"]) for x, y in zip(a, b)])


def pegasos_until_tie(torch, feats, labels, cfg):
    """Pegasos (core/svm.py) on the card's features, on the card and the
    CPU step by step from one schedule: w must stay within PEGASOS_TOL
    relative L2 until the first step whose active sets differ, and differ
    there only on margins within PEGASOS_TIE of the hinge. Returns
    ((step, CPU margin, card margin) of that tie or None, the CPU run's
    params)."""
    import repro_torch.core.svm as S
    f_c, f_g = feats.cpu(), feats
    y_c = labels.cpu().to(torch.float32) * 2 - 1
    y_g = y_c.to(feats.device)
    idx = S.train_schedule(len(f_c), cfg)
    lrs = torch.from_numpy(S.learning_rates(cfg))
    w_c, b_c = torch.zeros(f_c.shape[1]), torch.zeros(())
    w_g, b_g = w_c.to(feats.device), b_c.to(feats.device)
    tie = None
    for t in range(len(idx)):
        i_c, i_g = idx[t], idx[t].to(feats.device)
        if tie is None:
            v_c = 1.0 - y_c[i_c] * (f_c[i_c] @ w_c + b_c)
            v_g = (1.0 - y_g[i_g] * (f_g[i_g] @ w_g + b_g)).cpu()
            off = S.hinge_active(v_c) != S.hinge_active(v_g)
            if bool(off.any()):
                tie = (t, float(v_c[off][0]), float(v_g[off][0]))
                need(float(v_c[off].abs().max()) <= PEGASOS_TIE
                     and float(v_g[off].abs().max()) <= PEGASOS_TIE,
                     f"Pegasos step {t}: active sets differ on margins "
                     f"{v_c[off].tolist()} / {v_g[off].tolist()}")
            w_g, b_g, _ = S.pegasos_step(w_g, b_g, f_g[i_g], y_g[i_g],
                                         lrs[t].to(feats.device), cfg)
        w_c, b_c, _ = S.pegasos_step(w_c, b_c, f_c[i_c], y_c[i_c], lrs[t],
                                     cfg)
        if tie is None:
            rel = float(torch.linalg.vector_norm(w_g.cpu() - w_c)
                        / torch.linalg.vector_norm(w_c))
            need(rel <= PEGASOS_TOL, f"Pegasos step {t}: card vs CPU w rel "
                                     f"L2 {rel} before any tie")
    return tie, {"w": w_c, "b": b_c}


def cascade_path(torch, np, svm) -> dict:
    """Phase 4h: the cascade preset ("kernel" backend, the golden fine
    head at THRESHOLD). The coarse head trained on the card and on the CPU
    from one rng (the reference's schedule), within COARSE_W_TOL;
    CascadeDetector.detect on CASCADE_SCENES seeded 640x480 scenes and
    stream on a seeded clip on the card, counters reset just before and
    read just after, held against the CPU cascade (boxes equal, scores
    within SCORE_TOL); retention of the dense pass's pedestrian boxes,
    region_area_frac and the empty / dense frame counts. Then a resilient
    service (a registry of the fine head and the "_coarse" head) driven
    down to the cascade and coarse rungs by latency faults and back:
    every request answered, each rung's answers the card's own entry
    point's, the results after recovery the unperturbed ones."""
    import repro_torch.api as api
    import repro_torch.data.synth_pedestrian as synth
    import repro_torch.kernels as kernels
    from repro_torch.core.cascade import resize_windows, train_coarse_head
    from repro_torch.core.detector import DetectorConfig
    from repro_torch.core.heads import HeadRegistry
    from repro_torch.core.hog import hog_descriptor
    from repro_torch.data.mining import mine_hard_negatives
    from repro_torch.serve.faults import FaultInjector, FaultSpec

    def preset(name):
        cfg = api.presets(name)
        return cfg.replace(detector=dataclasses.replace(
            cfg.detector, score_threshold=THRESHOLD, backend="kernel"))

    cfg = preset("cascade")
    t0 = time.perf_counter()
    rec = {}
    coarse, ch = train_coarse_head(cfg.hog, cfg.train, *COARSE_N,
                                   rng=np.random.default_rng(CASCADE_SEED),
                                   mine_scenes=COARSE_MINE_SCENES,
                                   device=DEV, record=rec)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    # the CPU repeats the card's run as the train phase does: the same
    # windows' descriptors, its mining round with the card's first head
    # from the same rng state, and Pegasos on the card's final features
    # (a window within an ulp of the loose gate can fall on the other side
    # of it on the other device, so the CPU's own chain may mine another
    # crop and train another head: that is not compared)
    t0 = time.perf_counter()
    x, _ = synth.make_windows(*COARSE_N, synth.PedestrianDataConfig(),
                              np.random.default_rng(CASCADE_SEED))
    f_cpu = hog_descriptor(resize_windows(x, ch.window_h, ch.window_w,
                                          torch.device("cpu")), ch)
    f_card = rec["feats"][:len(x)].cpu()
    f_off = int((f_cpu != f_card).sum())
    need(float((f_cpu - f_card).abs().max()) <= COARSE_FEAT_TOL,
         "coarse head: the windows' descriptors differ on the CPU")
    (state, mined), = rec["rounds"]
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    mined_cpu = mine_hard_negatives(
        {k: v.cpu() for k, v in rec["first"].items()},
        DetectorConfig(hog=ch, scales=cfg.cascade.coarse_scales),
        COARSE_MINE_SCENES, rng, device="cpu")
    need(mined.shape == mined_cpu.shape and len(mined) > 0,
         f"coarse mining with the card's head: {mined.shape} crops on the "
         f"card, {mined_cpu.shape} on the CPU")
    crop_off = int((mined != mined_cpu).sum())
    need(int(np.abs(mined.astype(np.int16)
                    - mined_cpu.astype(np.int16)).max()) <= 1,
         "coarse mining: crops differ by more than one code")
    tie, params_cpu = pegasos_until_tie(torch, rec["feats"],
                                        rec["labels"], cfg.train)
    cpu_s = time.perf_counter() - t0
    rel = float(torch.linalg.vector_norm(coarse["w"].cpu() - params_cpu["w"])
                / torch.linalg.vector_norm(params_cpu["w"]))
    feats = rec["feats"].cpu()
    acc = [float(((feats @ p["w"].cpu() + p["b"].cpu() > 0)
                  == rec["labels"].cpu().bool()).float().mean())
           for p in (coarse, params_cpu)]

    gpu = api.DetectionSession(svm, cfg, device=DEV)
    casc = gpu.cascade(coarse_svm=coarse)
    ccasc = api.DetectionSession(svm, cfg, device="cpu").cascade(
        coarse_svm={k: v.cpu() for k, v in coarse.items()})
    rng = np.random.default_rng(CASCADE_SEED)
    scenes = [synth.make_scene(rng, 480, 640, n_people=i % 4)
              for i in range(CASCADE_SCENES)]
    clip, _ = synth.make_clip(np.random.default_rng(CASCADE_SEED),
                              synth.ClipConfig(n_frames=CASCADE_CLIP, h=480,
                                               w=640, n_people=2))
    kernels.reset_launches()
    got = [casc.detect(s) for s, _ in scenes]
    stats = dict(casc.stats)
    tracked = casc.stream(list(clip))
    torch.cuda.synchronize()
    launches = {"cascade+kernel": check_launches("cascade+kernel",
                                                 kernels.launch_counts())}
    worst = max(_same_dets(got[i], ccasc.detect(scenes[i][0]),
                           f"cascade scene {i}")
                for i in range(CASCADE_CPU_SCENES))
    want = ccasc.stream(list(clip))
    for t, (a, b) in enumerate(zip(tracked, want)):
        need([(x["track_id"], x["box"]) for x in a]
             == [(x["track_id"], x["box"]) for x in b],
             f"cascade stream frame {t}: tracks differ from the CPU's")
    need(worst <= SCORE_TOL["f32"], f"cascade: score delta {worst}")
    kept = total = 0
    for (scene, truth), dets in zip(scenes, got):
        tboxes = [(y, x, y + th, x + tw) for y, x, th, tw in truth]
        full = [d for d in gpu.detect(scene).to_list()
                if any(_iou(d["box"], t) >= 0.4 for t in tboxes)]
        total += len(full)
        for f in full:
            gt = max(range(len(tboxes)),
                     key=lambda j: _iou(f["box"], tboxes[j]))
            kept += any(_iou(f["box"], c["box"]) >= 0.5
                        or _iou(c["box"], tboxes[gt]) >= 0.4 for c in dets)
    need(total > 0, "cascade: the dense pass found no pedestrian")
    level_line(f"  cascade+kernel 640x480: coarse head, card {gpu_s:.1f} s;"
          f" CPU ({cpu_s:.1f} s): descriptors off {f_off}/{f_cpu.numel()}, "
          f"{len(mined)} mined = card ({crop_off} px a code off), Pegasos "
          f"= card's to {PEGASOS_TOL:g} "
          + (f"until a tie at step {tie[0]} ({tie[1]:.1e} / {tie[2]:.1e}),"
             f" then w rel L2 {rel:.1e}, accuracy {acc[1]:.4f} (card "
             f"{acc[0]:.4f})" if tie else
             f"through every step (w rel L2 {rel:.1e})")
          + f"; {CASCADE_SCENES} scenes"
          f" + {CASCADE_CLIP}-frame stream: {CASCADE_CPU_SCENES} scenes "
          f"and the stream = CPU (d {worst:.1e}); retained {kept}/{total}"
          f" dense pedestrian boxes; region_area_frac "
          f"{stats['region_area_frac'] / stats['frames']:.3f}, "
          f"{stats['regions']} regions, empty {stats['frames_empty']}, "
          f"dense {stats['frames_dense']}; "
          + _per_kernel([launches["cascade+kernel"]],
                        PATH_KERNELS["cascade+kernel"]), flush=True)

    # the resilient service: a registry session (fine head + "_coarse"),
    # lines from the slower of the full rung's p99 and the cascade's ms
    rcfg = preset("resilient")
    reg = HeadRegistry()
    reg.add("person", svm)
    reg.add("_coarse", coarse, metadata={"role": "cascade-coarse"})
    sess = api.DetectionSession(reg, rcfg, device=DEV)
    frames = [synth.make_scene(np.random.default_rng(70 + i), 480, 640,
                               n_people=2)[0]
              for i in range(RESILIENT_FRAMES)]
    base = [sess.detect(f).to_list() for f in frames]
    svc = sess.serve(frame_batch=1).start()
    for f in frames:
        svc.detect_frames([f], timeout=60)
    svc.stop()
    p99 = svc.stats["latency_ms"]["p99"]
    direct = sess.cascade()
    t0 = time.perf_counter()
    for f in frames:
        direct.detect(f)
    casc_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    line = max(p99, 2 * casc_ms)
    spike = 10 * line
    res_cfg = dataclasses.replace(
        rcfg.service.resilience, degrade_p99_ms=5 * line,
        recover_p99_ms=2.5 * line, recover_dwell=2, latency_window=4,
        deadline_ms=max(rcfg.service.resilience.deadline_ms, 4 * spike))
    inj = FaultInjector((FaultSpec("latency", at_batches=(2, 3, 4, 5),
                                   latency_ms=spike),), seed=0)
    kernels.reset_launches()
    svc = sess.serve(faults=inj, frame_batch=1, resilience=res_cfg).start()
    rungs = []
    for f in frames:
        r = svc.detect_frames([f], timeout=120)[0]
        need("detections" in r, f"resilient: unanswered: {r}")
        rung = r["degraded_mode"]
        rungs.append(rung)
        if rung != "full":
            want = direct.detect_degraded(f, rung)
            need(r["detections"] == want,
                 f"resilient: the {rung} rung's answer is not the "
                 f"cascade's own")
    need("cascade" in rungs and "coarse" in rungs,
         f"resilient: the ladder never reached cascade and coarse: {rungs}")
    deadline, extra = time.monotonic() + 120, 0
    while svc.stats["degraded_mode"] != "full":
        need(time.monotonic() < deadline,
             f"resilient: never recovered: {svc.stats['ladder']}")
        r = svc.detect_frames([frames[0]], timeout=120)[0]
        need("detections" in r, f"resilient: unanswered: {r}")
        extra += 1
    res = [svc.detect_frames([f], timeout=120)[0] for f in frames]
    svc.stop()
    torch.cuda.synchronize()
    launches["resilient+kernel"] = check_launches(
        "resilient+kernel", kernels.launch_counts())
    need([r["degraded_mode"] for r in res] == ["full"] * len(frames)
         and [r["detections"] for r in res] == base,
         "resilient: results after recovery differ from the unperturbed")
    level_line(f"  resilient+kernel service (person + _coarse registry), "
          f"{len(frames)} frames one a batch, lines from max(p99 "
          f"{p99:.1f}, 2 x cascade {casc_ms:.1f}) ms: spike {spike:.0f}, "
          f"degrade/recover {5 * line:.0f}/{2.5 * line:.0f}: rungs "
          + " ".join(f"{r} {rungs.count(r)}" for r in ("full", "cascade",
                                                       "coarse"))
          + f", each answer = the card's own rung; full after {extra} "
          f"more, {svc.stats['ladder']['transitions']} transitions, same "
          f"results", flush=True)
    return launches


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
    level_line(f"  window paper+kernel: all {len(wins)} windows of one 640x480 "
          f"frame (levels {'+'.join(map(str, per_level))}), chunks of "
          f"{WINDOW_CHUNK}: max delta vs the dense score_map {d:.2e} "
          f"(tol {LAYOUT_TOL:g})", flush=True)

    level_line("  window timing, per batch: host ms, windows/s, launches, "
               "device busy ms (share of host ms), own kernels' device ms")
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
        level_line(f"  {name}: " + "; ".join(parts))
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
        level_line(f"    {cpu_line}; kernels: human = predict beyond {tol:.1e}, "
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
    level_line(f"  save/load: same w, b, {len(a)} boxes; CLI --fast --scenes 2 "
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
          f"= card bit for bit, CPU boxes; own-kernel launches (others 0): "
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
    level_line(f"  serve chaos paper+kernel, {len(chaos)} frames one a batch: "
          f"fired {'/'.join(fired)}, {cstats['restarts']} restarts, "
          f"{cstats['retries']} retries, same results, stop {stop_s:.2f} s;"
          f" degradation (p99 {p99:.2f} ms: spike {spike:.1f}, lines "
          f"{5 * p99:.1f}/{2.5 * p99:.1f}): {rungs.count('reduced')} frames "
          f"reduced = CPU reduced_detector (delta {max(rdelta):.1e}), full "
          f"after {extra} more, {trans} transitions, same results")
    return launches


# ------------------------------------------------------------- phase 5

# ------------------------------------------------------------- phase 4i

def check_uhd_kernels(torch, np, summary) -> None:
    """Each dense kernel against its plain version at the shapes the tiled
    path gives it: the three levels of a 3840x2160 frame, the slabs a tile
    computes (fp 4 and 2 at level 1.0: 634 and 1,146 rows; fp 4 at 0.64)
    and a batch of KERNEL_BATCH level-1.0 frames (a scorer output of
    108M floats), in every mode; the limits of phase 3, fused equal to the
    pair bit for bit. The worst errors join ``summary`` (the kernels
    line's err is the worst at any shape)."""
    import repro_torch.core.quant as quant
    import repro_torch.kernels.dense_block_norm as dbn
    import repro_torch.kernels.dense_grad_hist as dgh
    import repro_torch.kernels.fused_hog as fh
    import repro_torch.kernels.svm_matmul as sm

    gw = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")["svm_w"]
    wt32 = torch.from_numpy(gw).to(DEV).reshape(105, 36).T.contiguous()
    wq = quant.quantize_weight_columns(wt32)[0].contiguous()
    levels = level_shapes(*UHD)
    shapes = [(1,) + s for s in levels]
    for fp, i in ((4, 0), (2, 0), (4, 2)):
        sph = (levels[i][0] - 2) // 8 - 15
        shapes.append((1, (-(-sph // fp) + 15) * 8 + 2, levels[i][1]))
    shapes.append((KERNEL_BATCH,) + levels[0])
    rng = np.random.default_rng(3)
    worst = {}

    def note(k, mode, e):
        worst[(k, mode)] = max(worst.get((k, mode), 0.0), e)

    for shape in shapes:
        # the batch checks the two modes that feed the scorers; every
        # mode at one frame's shapes
        modes = (("sector", "fixed") if shape[0] > 1 else tuple(MODE_NORMS))
        for mode in modes:
            norm = MODE_NORMS[mode]
            gray = torch.from_numpy(
                (rng.integers(0, 256, shape) if mode == "fixed"
                 else rng.uniform(0, 255, shape)).astype(np.float32)).to(DEV)
            hist = dgh.dense_grad_hist(gray, mode=mode)
            want = dgh.dense_grad_hist_plain(gray, mode=mode)
            diff = (hist.float() - want.float()).abs()
            note("dense_grad_hist", mode, float(diff.max()))
            need(torch.equal(hist, want) if mode == "fixed" else
                 bool((diff <= HIST_ATOL + HIST_RTOL * want.abs()).all()),
                 f"dense_grad_hist {mode} {shape}: max err {diff.max()}")
            blocks = dbn.dense_block_norm(hist, mode=norm)
            fused = fh.dense_fused_hog(gray, mode=mode)
            need(torch.equal(fused, blocks), f"dense_fused_hog {mode} "
                 f"{shape}: not the pair's output bit for bit")
            for k, m, want in (
                    ("dense_block_norm", norm,
                     dbn.dense_block_norm_plain(hist, mode=norm)),
                    ("dense_fused_hog", mode,
                     fh.dense_fused_hog_plain(gray, mode=mode))):
                e = float((blocks - want).abs().max())
                note(k, m, e)
                need(code_flips(blocks, want) <= 1e-3 * want.numel()
                     if mode == "fixed" else e <= BLOCK_ATOL,
                     f"{k} {m} {shape}: max err {e}")
            flat = blocks.reshape(-1, 36)
            if mode == "fixed":
                q = quant.quantize_blocks(flat)[0]
                need(torch.equal(sm.score_matmul_int8(q, wq),
                                 sm.score_matmul_int8_plain(q, wq)),
                     f"score_matmul_int8 {shape}: not its plain version")
                note("score_matmul_int8", "int8", 0.0)
                continue
            for dname, dt in (("f32", torch.float32),
                              ("bf16", torch.bfloat16)):
                x, w = flat.to(dt).contiguous(), wt32.to(dt).contiguous()
                e = float((sm.score_matmul(x, w)
                           - sm.score_matmul_plain(x, w)).abs().max())
                note("score_matmul", dname, e)
                need(e <= MATMUL_ATOL[dname],
                     f"score_matmul {dname} {shape}: {e}")
            del gray, hist, want, blocks, fused, flat
    torch.cuda.synchronize()
    for (k, mode), e in worst.items():
        entry = summary[k].setdefault(mode, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], e)
        summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"], e)
    level_line(f"  uhd kernels = plain at {len(levels)} levels of "
          f"{UHD[1]}x{UHD[0]}, slabs of " + "/".join(
              str(s[1]) for s in shapes[3:-1]) + f" rows, B{KERNEL_BATCH} "
          f"level 1.0, every mode (fused = pair bit for bit); worst err "
          + ", ".join(f"{k.replace('dense_', '')} " + format(max(
              e for (kk, _), e in worst.items() if kk == k), ".1e")
                      for k in dict.fromkeys(k for k, _ in worst)))


def same_kept(got, ref, tol: float, iou_thr: float) -> int:
    """The card's kept boxes (``got``, a Detections) against the CPU's
    (``ref``): the same boxes in the same order, scores within ``tol``;
    or, where two candidates' scores lie within 2 tol (a near-tie the
    tolerance allows to swap), the same boxes but for such pairs: a
    pair in the other order, one of an overlapping pair (IoU > the NMS
    threshold) kept instead of the other, or a box at the top-k's edge
    (within 2 tol of the other side's last candidate). Returns the boxes
    a near-tie placed; fails on anything else."""
    g, c = got.to_list(), ref.to_list()
    sg = {d["box"]: d["score"] for d in g}
    sc = {d["box"]: d["score"] for d in c}
    for b in sg.keys() & sc.keys():
        need(abs(sg[b] - sc[b]) <= tol, f"box {b}: score {sg[b]} on the "
             f"card, {sc[b]} on the CPU (tol {tol})")
    if [d["box"] for d in g] == [d["box"] for d in c]:
        return 0
    placed = set()
    pg = {d["box"]: i for i, d in enumerate(g)}
    pc = {d["box"]: i for i, d in enumerate(c)}
    common = sorted(sg.keys() & sc.keys(), key=pg.get)
    for i, a in enumerate(common):          # pairs in the other order
        for b in common[i + 1:]:
            if pc[a] > pc[b]:
                need(abs(sg[a] - sg[b]) <= 2 * tol, f"boxes {a} and {b} "
                     f"swap order with scores {sg[a]} and {sg[b]}")
                placed.update((a, b))

    def iou(a, b):
        h = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        w = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = h * w
        area = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0])
                * (b[3] - b[1]) - inter)
        return inter / max(area, 1e-9)

    for mine, other, det in ((sg, sc, ref), (sc, sg, got)):
        edge = float(det._scores.cpu().min())
        for a in mine.keys() - other.keys():
            partner = any(iou(a, b) > iou_thr
                          and abs(mine[a] - other[b]) <= 2 * tol
                          for b in other.keys() - mine.keys())
            need(partner or abs(mine[a] - edge) <= 2 * tol,
                 f"box {a} (score {mine[a]}) kept on one side only, with "
                 f"no near-tie that explains it ({len(sg)} vs {len(sc)} "
                 f"kept)")
            placed.add(a)
    return len(placed)


def tiled_path(torch, np, svm, summary) -> dict:
    """Phase 4i: the uhd preset on one seeded 3840x2160 scene, untiled on
    the card (frame_parallel 0 is the one card) with the "kernel"
    backend, perf's and quant's numerics on the fused one, counters reset
    before each and read after; kept boxes against the CPU session
    (SCORE_TOL), each banded level equal to the CPU's bit for bit;
    ms/frame, launches, busy ms, K, n_valid, saturation, each dense
    kernel's device ms a frame and the K-step NMS alone. Then the same
    frame tiled over TILE_DEVICES logical devices (REPRO_TEST_DEVICES):
    slab fp 2 and 4 and scale fp 2, banded and matmul, each equal to the
    untiled card result bit for bit; then sharded batches of 640x480
    scenes (the sharded preset over the cards there are, and dp 2 over
    7 frames) equal to the paper preset's detect_batch bit for bit."""
    import repro_torch.api as api
    import repro_torch.data.synth_pedestrian as synth
    import repro_torch.kernels as kernels
    from repro_torch.core.detector import FrameDetector, _prep_frame

    check_uhd_kernels(torch, np, summary)
    scene = synth.make_scene(np.random.default_rng(UHD_SEED), *UHD,
                             n_people=UHD_PEOPLE)[0]

    def config(base, preset, backend):
        cfg = api.presets(preset)
        return base.replace(hog=cfg.hog, detector=dataclasses.replace(
            base.detector, hog=cfg.hog, backend=backend,
            score_threshold=THRESHOLD))

    launches, untiled, text, dev_ms, first = {}, {}, [], [], None
    for name, (preset, backend, dt) in UHD_CONFIGS.items():
        cfg = config(api.presets("uhd"), preset, backend)
        gpu = api.DetectionSession(svm, cfg, device=DEV)
        cpu = api.DetectionSession(svm, cfg, device="cpu")
        need(gpu.detector.frame_devices == torch.cuda.device_count(),
             f"{name}: frame_parallel 0 did not resolve to the cards")
        kernels.reset_launches()
        d = gpu.detect(scene).block_until_ready()
        launches[name] = check_launches(name, kernels.launch_counts())
        on_cpu = cpu.detect(scene)
        got, ref = d.to_list(), on_cpu.to_list()
        need(len(got) >= 3, f"{name}: only {len(got)} boxes kept")
        ties = same_kept(d, on_cpu, SCORE_TOL[dt], cfg.detector.nms_iou)
        sc = {x["box"]: x["score"] for x in ref}
        de = max(abs(x["score"] - sc[x["box"]]) for x in got
                 if x["box"] in sc)
        untiled[name] = got
        lv = []
        for sess in (gpu, cpu):
            prog, ph, pw = sess.detector.program_for(*UHD)
            gray = _prep_frame(torch.as_tensor(scene).to(sess.device),
                               *UHD, ph, pw)
            lv.append([g.cpu() for g in [gray] + prog.pyramid(gray)[1:]])
        need(all(torch.equal(a, b) for a, b in zip(*lv)),
             f"{name}: a banded level differs from the CPU's")
        t0 = time.perf_counter()
        for _ in range(UHD_REPS):
            gpu.detect(scene).block_until_ready()
        ms = (time.perf_counter() - t0) * 1e3 / UHD_REPS
        times = device_times(
            torch, lambda: gpu.detect(scene).block_until_ready(), 1)
        busy = sum(t for _, t in times.values()) / 1e3
        text.append(f"{name} {ms:.1f} {sum(c for c, _ in times.values())} "
                    f"{busy:.2f} {len(got)} ({ties}) {de:.0e} "
                    f"{int(d._n_valid)} {int(d.saturated)}")
        first = first or gpu
        per = {k: sum(t for n, (_, t) in times.items() if k + "_kernel" in n)
               for k in PATH_KERNELS[name]}
        dev_ms.append(" ".join(f"{k.replace('dense_', '')} {us / 1e3:.3f}"
                               for k, us in per.items()))
    prog = gpu.detector.program_for(*UHD)[0]
    print(f"  uhd {UHD[1]}x{UHD[0]} K {prog.k} of {prog.n_positions}, "
          f"levels = CPU bit for bit; ms/frame launches busy-ms kept (= "
          f"CPU; near-tie swaps) delta n_valid saturated: " + "; ".join(text),
          flush=True)
    # each stage alone (the K-step top-k + NMS on K of the frame's
    # positions), and each dense kernel's device ms in a frame
    split = frame_split(torch, np, first, *UHD)
    level_line("  uhd split ms (uhd+kernel): " + " ".join(
        f"{k[:-3]} {v:.3f}" for k, v in split.items())
          + "; kernels' device ms/frame: " + "; ".join(dev_ms), flush=True)

    # tiled on the card: every tile, one after another, on the one card
    base = config(api.presets("uhd"), "paper", "kernel").detector
    want = {"banded": untiled["uhd+kernel"],
            "matmul": FrameDetector(svm, dataclasses.replace(
                base, pyramid_resize="matmul"), device=DEV)
            .detect_raw(scene).to_list()}
    os.environ["REPRO_TEST_DEVICES"] = str(TILE_DEVICES)
    try:
        kernels.reset_launches()
        tiled_ms = {}
        for resize in ("banded", "matmul"):
            for mode, fp in TILED_CASES:
                det = FrameDetector(svm, dataclasses.replace(
                    base, pyramid_resize=resize, tile_mode=mode,
                    frame_parallel=fp), device=DEV)
                t0 = time.perf_counter()
                got = det.detect_raw(scene).to_list()
                tiled_ms[(resize, mode, fp)] = (time.perf_counter()
                                                - t0) * 1e3
                need(det._tiled_steps, f"{resize} {mode} fp {fp}: untiled")
                need(got == want[resize], f"tiled {resize} {mode} fp {fp}: "
                     f"not the untiled card result bit for bit")
        launches["tiled uhd+kernel"] = check_launches(
            "tiled uhd+kernel", kernels.launch_counts())
    finally:
        os.environ.pop("REPRO_TEST_DEVICES")
    level_line(f"  tiled uhd+kernel, {TILE_DEVICES} logical devices on one card:"
          f" " + ", ".join(f"{m} fp{fp}" for m, fp in TILED_CASES)
          + " x banded/matmul = untiled card to_list() bit for bit "
          f"({len(want['banded'])}/{len(want['matmul'])} kept); first-call "
          f"ms " + " ".join(f"{v:.0f}" for v in tiled_ms.values()),
          flush=True)

    # sharded batches: the cards there are, then dp 2 with a pad frame
    frames = [synth.make_scene(np.random.default_rng(50 + i), 480, 640,
                               n_people=3)[0] for i in range(SHARDED_B)]
    want = api.DetectionSession(svm, config(
        api.presets("paper"), "paper", "kernel"), device=DEV
    ).detect_batch(frames).to_list()
    sharded = config(api.presets("sharded"), "paper", "kernel")
    sess = api.DetectionSession(svm, sharded, device=DEV)
    need(sess.data_devices == torch.cuda.device_count(),
         "the sharded preset did not resolve to the cards")
    kernels.reset_launches()
    got = [sess.detect_batch(frames).to_list()]
    os.environ["REPRO_TEST_DEVICES"] = str(SHARDED_DP)
    try:
        two = api.DetectionSession(svm, sharded.replace(
            detector=dataclasses.replace(sharded.detector,
                                         data_parallel=SHARDED_DP)),
            device=DEV)
        got.append(two.detect_batch(frames).to_list())
        launches["sharded paper+kernel"] = check_launches(
            "sharded paper+kernel", kernels.launch_counts())
    finally:
        os.environ.pop("REPRO_TEST_DEVICES")
    need(all(g == want for g in got),
         "a sharded batch differs from the paper preset's detect_batch")
    level_line(f"  sharded paper+kernel 640x480 B{SHARDED_B}: dp "
          f"{torch.cuda.device_count()} (the cards) and dp {SHARDED_DP} "
          f"(one pad frame) = paper detect_batch bit for bit "
          f"({sum(map(len, want))} kept)", flush=True)
    print("  " + launch_line(launches), flush=True)
    return launches


def smoke_leaves(np, cfg, seed: int) -> dict:
    """The reference's LM parameter tree at ``cfg``'s size as f32 numpy
    arrays, layers stacked on axis 0 (the encoder's on their own), with
    its distributions (normal x fan_in^-0.5, x 0.02 for embed, lm_head,
    the router and the meta tokens, x ssm_conv^-0.5 for the conv, ones
    for the norm scales, zeros for layernorm's biases, the SSM's A_log,
    D_skip and dt_bias as the reference sets them), from a seeded numpy
    generator."""
    rng = np.random.default_rng(seed)
    L, D, H, K, hd, Fd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab)

    def dense(shape, std=None):
        x = rng.standard_normal(shape, dtype=np.float32)
        return x * np.float32(std if std else shape[-2] ** -0.5)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def nrm(*lead):
        t = {"scale": ones(*lead, D)}
        if cfg.norm == "layernorm":
            t["bias"] = np.zeros(lead + (D,), np.float32)
        return t

    def swiglu(L=L):
        if cfg.mlp == "gelu":
            return {"w_up": dense((L, D, Fd)), "w_down": dense((L, Fd, D))}
        return {"w_gate": dense((L, D, Fd)), "w_up": dense((L, D, Fd)),
                "w_down": dense((L, Fd, D))}

    def attn(L=L):
        a = {"wq": dense((L, D, H * hd)), "wk": dense((L, D, K * hd)),
             "wv": dense((L, D, K * hd)), "wo": dense((L, H * hd, D))}
        if cfg.qk_norm:
            a.update(q_norm=ones(L, hd), k_norm=ones(L, hd))
        return a

    lay = {"ln1": nrm(L), "ln2": nrm(L)}
    if cfg.has_attention:
        lay["attn"] = attn()
    if cfg.has_ssm:
        Hs, di = cfg.ssm_heads, cfg.d_inner
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (L, Hs))
                    ).astype(np.float32)
        lay["ssm"] = {
            "in_proj": dense((L, D, 2 * di + 2 * cfg.ssm_groups
                              * cfg.ssm_state + Hs)),
            "conv_w": dense((L, cfg.conv_dim, cfg.ssm_conv),
                            cfg.ssm_conv ** -0.5),
            "conv_b": np.zeros((L, cfg.conv_dim), np.float32),
            "A_log": np.log(np.broadcast_to(np.arange(
                1, Hs + 1, dtype=np.float32), (L, Hs))),
            "D_skip": ones(L, Hs), "dt_bias": dt + np.log(-np.expm1(-dt)),
            "norm_scale": ones(L, di), "out_proj": dense((L, di, D))}
        if cfg.family == "hybrid":
            lay["bn_attn"] = nrm(L)
            lay["bn_ssm"] = nrm(L)
    if cfg.is_moe:
        E = cfg.n_experts
        lay["moe"] = {"router": dense((L, D, E), 0.02),
                      "w_gate": dense((L, E, D, Fd)),
                      "w_up": dense((L, E, D, Fd)),
                      "w_down": dense((L, E, Fd, D))}
        if cfg.shared_expert:
            lay["moe"]["shared"] = swiglu()
    elif cfg.family != "ssm":
        lay["mlp"] = swiglu()
    if cfg.encoder_layers:
        lay["xattn"], lay["ln_x"] = attn(), nrm(L)
    tree = {"embed": dense((V, D), 0.02), "final_norm": nrm(),
            "layers": lay}
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense((D, V), 0.02)
    if cfg.meta_tokens:
        tree["meta"] = dense((cfg.meta_tokens, D), 0.02)
    if cfg.encoder_layers:
        Le = cfg.encoder_layers
        tree["enc_layers"] = {"ln1": nrm(Le), "ln2": nrm(Le),
                              "attn": attn(Le), "mlp": swiglu(Le)}
        tree["enc_norm"] = nrm()
    return tree


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

    cfg = dc.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
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
    print(f"  lm {LM_ARCH} full width ({cfg.n_layers} layers, {n / 1e9:.4f} "
          f"B parameters, init {t_init:.1f} s, peak {peak:.2f} GiB): tokens "
          f"in range, rerun same; prefill vs pre[:-1] + decode "
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


def decode_consistency(torch, params, cfg, x, positions=None, enc=None):
    """The last logits of prefill(x), of prefill(x[:, :-1]) +
    decode_step, and their relative L2 distance for the sound decode and
    for two planted decode faults. Attention families: RoPE at one
    position past the token's ("pos+1"), and the new key and value
    written one slot early ("kv@idx-1"); M-RoPE: the h stream of the
    decode position one past ("mrope-h+1") and "kv@idx-1"; the
    encoder-decoder (``enc``: its encoder states): cross-attention
    reading the next row's encoder states ("enc-row") and the sinusoidal
    row one past the token's ("pe+1"); the SSM family: the conv window
    missing its newest entry (zeros in its place, "conv-new"), and the
    state update without the decay ("no-decay"). ``positions``: the full
    prompt's (B, S, 3) M-RoPE positions, its last token at S - 1 on all
    three streams, where decode_step places it. Each decode starts from
    the prefill's cache: what a decode can write (the two last key and
    value slots, the SSM state and conv) is put back after it."""
    import repro_torch.models.model as mm
    import repro_torch.models.ssm as ssm

    n = x.shape[1]
    full = {"tokens": x}
    part = {"tokens": x[:, :-1]}
    if positions is not None:
        full["positions"], part["positions"] = positions, positions[:, :-1]
    a = mm.prefill(params, full, cfg, n, enc=enc)[0][:, -1].float()
    _, cache = mm.prefill(params, part, cfg, n, enc=enc)
    i0 = cache["idx"] - 1
    kept = {t: (cache[t][:, :, i0:] if t in ("k", "v") else cache[t]).clone()
            for t in ("k", "v", "state", "conv") if t in cache}
    layer, window, update, pe = (mm._decode_layer, ssm._conv_window,
                                 ssm._state_update, mm.decoder_pe)

    def h_plus_1(pos):
        pos = pos.clone()
        pos[..., 1] += 1
        return pos

    kv_early = (mm, "_decode_layer", lambda h, lp, c, cl, pos, w, e=None,
                x=None: layer(h, lp, c, {**cl, "idx": cl["idx"] - 1}, pos, w,
                              e, x))
    if cfg.encoder_layers:
        faults = {
            "enc-row": (mm, "_decode_layer", lambda h, lp, c, cl, pos, w, e,
                        x=None: layer(h, lp, c, cl, pos, w, e.roll(1, 0), x)),
            "pe+1": (mm, "decoder_pe", lambda idx, d, device:
                     pe(idx + 1, d, device))}
    elif cfg.mrope:
        faults = {
            "mrope-h+1": (mm, "_decode_layer", lambda h, lp, c, cl, pos, w,
                          e=None, x=None: layer(h, lp, c, cl, h_plus_1(pos),
                                                w, e, x)),
            "kv@idx-1": kv_early}
    elif cfg.has_attention:
        faults = {
            "pos+1": (mm, "_decode_layer", lambda h, lp, c, cl, pos, w,
                      e=None, x=None: layer(h, lp, c, cl, pos + 1, w, e, x)),
            "kv@idx-1": kv_early}
    else:
        faults = {
            "conv-new": (ssm, "_conv_window", lambda conv, new:
                         window(conv, torch.zeros_like(new))),
            "no-decay": (ssm, "_state_update", lambda st, dec, upd:
                         st + upd)}
    rel, b = {}, None
    for name, fault in [("sound", None)] + list(faults.items()):
        if fault:
            setattr(*fault)
        try:
            step = mm.decode_step(params, x[:, -1:], cache, cfg, enc=enc)[0]
        finally:
            mm._decode_layer, ssm._conv_window, ssm._state_update, \
                mm.decoder_pe = layer, window, update, pe
        with torch.inference_mode():
            for t, v in kept.items():
                (cache[t][:, :, i0:] if t in ("k", "v") else cache[t]
                 ).copy_(v)
        rel[name] = float((a - step[:, -1].float()).norm() / a.norm())
        b = step[:, -1].float() if b is None else b
    return a, b, rel


def moe_drops(torch, fn):
    """Run ``fn()`` recording each MoE layer's dropped choices: -> (fn's
    result, one (T, top_k) bool tensor per moe._route call, True where
    that choice of that token overflowed its expert)."""
    import repro_torch.models.moe as moe

    route, calls = moe._route, []

    def recording(x_flat, gates, cfg, capacity):
        out = route(x_flat, gates, cfg, capacity)
        calls.append((out[2] == capacity).view(-1, cfg.top_k))
        return out

    moe._route = recording
    try:
        return fn(), calls
    finally:
        moe._route = route


def attended_pairs(S: int, window: int, n_meta: int) -> int:
    """(query, key) pairs a causal mask over S positions keeps, within
    ``window`` keys and the first ``n_meta`` (make_mask's rule)."""
    if not window:
        return S * (S + 1) // 2
    return sum(min(q + 1, window) + max(0, min(n_meta, q - window + 1))
               for q in range(S))


def flash_layers(cfg) -> int:
    """The decoder layers whose prefill attention takes flash: every
    layer without a window where the family attends (hymba's global
    layers), none for mamba2."""
    from repro_torch.models.model import layer_windows
    return sum(w == 0 for w in layer_windows(cfg)) if cfg.has_attention \
        else 0


def lm_bounds(cfg, B: int, S: int, pairs=None):
    """The least milliseconds of one prefill of B x S tokens and of one
    decode step after it on the card, each the larger of bytes and each
    type's operations. Prefill: the weights' bytes; the bf16 matmuls
    (projections, the attended (query, key) pairs of each layer's mask --
    ``pairs`` where the positions' mask is not index-causal --, the FFN:
    swiglu's three matmuls, gelu's two, the MoE's router and every
    expert's capacity buffer as the reference computes them, the SSD's
    y_intra; whisper's encoder over encoder_ctx frames with every key
    visible, and each decoder layer's cross-attention: its query and
    output projections, the encoder states' keys and values, the scores
    against every frame) at the bf16 rate, the SSD's f32 einsums at the
    f32 rate. Decode: bytes -- every weight (all experts: the expert
    matmuls multiply every buffer), the live KV cache, the SSM state read
    and written, the encoder states each layer reads -- against the
    operations of B tokens through the weights and the attention, and
    whisper's cross keys and values, recomputed from the encoder states
    in every layer at every step as the reference does."""
    from repro_torch.models.model import layer_windows
    from repro_torch.models.moe import _capacity

    D, V, L, M = cfg.d_model, cfg.vocab, cfg.n_layers, cfg.meta_tokens
    Sm = S + M
    T = B * Sm
    H, K, hd, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    ffn = (4 if cfg.mlp == "gelu" else 6) * D * Fd      # per token
    proj = 4 * D * (H + K) * hd                         # q, k, v, o
    weights = 2 * (cfg.param_count()
                   - (0 if cfg.tie_embeddings else V * D))
    bf = 2 * B * D * V                               # the last logits
    f32 = kv = state = 0
    Se, Le = cfg.encoder_ctx, cfg.encoder_layers
    nrm = 2 * D if cfg.norm == "layernorm" else D
    enc_params = Le * (2 * nrm + proj // 2 + ffn // 2) + (nrm if Le else 0)
    # a decode step reads no encoder weight; its B tokens go through every
    # other matmul weight but the embedding table (the cross-attention's
    # keys and values through theirs on the encoder states instead)
    dec_weights = weights - 2 * enc_params
    dec = 2 * B * (cfg.param_count() - enc_params - V * D * (
        1 if cfg.tie_embeddings else 2) - (L * 2 * D * K * hd if Le else 0)) \
        + 2 * B * D * V
    for _ in range(Le):
        bf += B * Se * (proj + ffn) + 4 * B * H * hd * Se * Se
    for window in layer_windows(cfg):
        if cfg.has_attention:
            p = attended_pairs(Sm, window, M) if pairs is None or window \
                else pairs
            bf += T * proj + 4 * B * H * hd * p
            kv += 4 * B * (Sm + 1) * K * hd
            dec += 4 * B * H * hd * (Sm + 1)
        if Le:
            enc_kv = 4 * B * Se * D * K * hd         # keys, values of enc
            bf += T * 2 * D * H * hd + 4 * T * H * hd * Se + enc_kv
            dec += 4 * B * H * hd * Se + enc_kv
            kv += 2 * B * Se * D                     # the encoder states
        if cfg.has_ssm:
            di, G, N, Hs, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                               cfg.ssm_heads, cfg.ssm_headdim)
            Q = min(cfg.ssm_chunk, Sm)
            nq = -(-Sm // Q) * Q
            bf += 2 * T * D * (2 * di + 2 * G * N + Hs) + 2 * T * di * D \
                + 2 * B * nq * Q * Hs * P
            f32 += 2 * B * nq * Q * G * N + 4 * B * nq * Hs * N * P
            state += 8 * B * Hs * N * P
        if cfg.is_moe:
            bf += 2 * T * D * cfg.n_experts \
                + 6 * cfg.n_experts * _capacity(T, cfg) * D * Fd \
                + (6 * T * D * Fd if cfg.shared_expert else 0)
        elif cfg.family != "ssm":
            bf += T * ffn
    pre = max(weights / HBM_BPS, bf / BF16_FLOPS, f32 / F32_FLOPS) * 1e3
    return pre, max((dec_weights + kv + state) / HBM_BPS,
                    dec / BF16_FLOPS) * 1e3


def lm_families(torch, np):
    """The lm families phase: the MoE, SSM and hybrid families. At smoke
    size (f32, weights through lm_params_from_numpy; llama4-scout too)
    the card's greedy tokens and logits against the CPU port's; at full
    width in bf16 (seeded random weights made on the card) for each of
    LM_FAMILIES: parameters = param_count(), generate for its prompts
    with the counters reset just before and read just after (flash
    launches per prefill = its layers without a window, all sm90), the
    same tokens on a rerun, the MoE's dropped choices per prefill,
    prefill vs prefill[:-1] + decode_step in bf16 and, with its planted
    faults, in f32, ms and bounds per prefill and decode step, busy ms,
    launches and peak GiB."""
    import dataclasses as dc

    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.model import decode_step, encode, prefill

    B0, S0 = LM_SMOKE_PROMPT
    smoke = []
    for arch in LM_FAMILIES + LM_SMOKE_ONLY + (LM_ENCDEC, LM_VLM) + LM_DENSE:
        scfg = dc.replace(get_config(arch, smoke=True), dtype=torch.float32)
        leaves = smoke_leaves(np, scfg, 0)
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, scfg.vocab, (B0, S0))
        # whisper: seeded frame embeddings; qwen2-vl: the image layout
        extra = {}
        if scfg.encoder_layers:
            extra["enc_input"] = rng.standard_normal(
                (B0, scfg.encoder_ctx, scfg.d_model), dtype=np.float32)
        if scfg.mrope:
            extra["positions"] = vlm_positions(np, "image", B0, S0,
                                               VLM_SMOKE_IMAGE)
        outs = {}
        for dev in (DEV, "cpu"):
            p = lm_params_from_numpy(leaves, scfg, dev)
            toks = lm_generate(torch, p, scfg, prompt, 8, **extra)
            first, cache = prefill(p, {"tokens": toks[:, :S0], **extra},
                                   scfg, S0 + 8)
            enc = encode(p, extra["enc_input"], scfg) \
                if scfg.encoder_layers else None
            step, _ = decode_step(p, toks[:, S0:S0 + 1], cache, scfg, enc=enc)
            outs[dev] = [x.cpu() for x in (toks, first, step)]
        need(torch.equal(outs[DEV][0], outs["cpu"][0]),
             f"{arch} smoke: greedy tokens differ between the card and CPU")
        de = max(float((a.float() - b.float()).abs().max())
                 for a, b in zip(outs[DEV][1:], outs["cpu"][1:]))
        need(de <= LM_SMOKE_TOL, f"{arch} smoke logits card vs CPU: {de}")
        smoke.append(f"{arch.split('-')[0]} {de:.1e}")
        del p
    print(f"  smoke f32 {B0}x{S0}+8, greedy tokens = CPU, logits max delta "
          f"(tol {LM_SMOKE_TOL:g}): " + ", ".join(smoke), flush=True)

    launches, routes = {}, dict.fromkeys(fa.ROUTES, 0)
    for arch in LM_FAMILIES:
        n, sm90 = full_width(torch, np, arch,
                             LM_FAMILY_BATCHES.get(arch, LM_BATCHES[:1]))
        launches[f"lm {arch}"] = n
        routes["sm90"] += sm90
    return launches, routes


def full_width(torch, np, arch: str, groups, f32_layers=None,
               predicted: str = "", out=print):
    """One arch of the lm families checks at full width in bf16 (seeded
    random weights made on the card): parameters = param_count(),
    generate for each of ``groups`` with the counters reset just before
    and read just after (flash launches per prefill = its layers without
    a window, all sm90), the same tokens on a rerun, the MoE's dropped
    choices per prefill, prefill vs prefill[:-1] + decode_step in bf16
    and, with its planted faults, in f32 (at ``f32_layers`` of its depth
    where given: the f32 weights must fit the card), ms and bounds per
    prefill and decode step, busy ms, launches and peak GiB; one line,
    ``predicted`` (the dry run's) beside the peak, printed by ``out``.
    -> (its launches, its sm90 launches)."""
    import dataclasses as dc

    import repro_torch.kernels as kernels
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.serve.engine import generate

    cfg = get_config(arch)
    if arch in FAMILY_LAYERS:
        cfg = dc.replace(cfg, n_layers=FAMILY_LAYERS[arch])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    n = sum(t.numel() for t in params.parameters())
    need(n == cfg.param_count(), f"{arch}: {n} parameters, config "
                                 f"{cfg.param_count()}")
    rng = np.random.default_rng(2)
    prompts = {g: rng.integers(0, cfg.vocab, (B, S)) for g, B, S in groups}
    kernels.reset_launches()
    toks = {g: generate(params, cfg, x, LM_NEW) for g, x in prompts.items()}
    torch.cuda.synchronize()
    name = f"lm {arch}"
    launches = check_launches(name, kernels.launch_counts())
    per = flash_layers(cfg)
    got = dict(fa.flash_attention.route_launches)
    need(got == {"sm90": per * len(groups), "cuda_core": 0},
         f"{arch}: flash routes {got} in {len(groups)} bf16 prefills, "
         f"want sm90 {per} each")
    for g, B, S in groups:
        t = toks[g]
        need(t.shape == (B, S + LM_NEW) and bool(((t >= 0)
                                                  & (t < cfg.vocab)).all())
             and torch.equal(t[:, :S].cpu(), torch.from_numpy(prompts[g])),
             f"{arch} {g}: tokens out of shape or range, or prompt changed")
    g0 = groups[0][0]
    need(torch.equal(generate(params, cfg, prompts[g0], LM_NEW), toks[g0]),
         f"{arch} {g0}: a second generate gave other tokens")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # the consistency prompt: the last group's (hymba's B 1 x S 2,048,
    # where decode reads past the window)
    gc = groups[-1][0]
    x = torch.as_tensor(prompts[gc], device=DEV)
    ccfg, drops = cfg, ""
    if cfg.is_moe:
        # a prefill ranks tokens in order, so an overflowing expert
        # drops the last positions first: prefill vs prefill[:-1] +
        # decode_step is sound only where no row's last position lost
        # a choice in any layer. The checks run at capacity factor
        # E / k, where no drop is possible (the reference's smoke
        # configs use 8.0 for this)
        calls = moe_drops(torch, lambda: prefill(params, {"tokens": x},
                                                 cfg, x.shape[1]))[1]
        lost = torch.stack(calls).view(len(calls), x.shape[0],
                                       x.shape[1], -1)
        n_last = int(lost[:, :, -1].any(-1).sum())
        r = decode_consistency(torch, params, cfg, x)[2]["sound"]
        need(n_last or r <= CONSIST_TOL, f"{arch}: prefill vs prefill "
             f"+ decode_step at cf {cfg.capacity_factor:g}, no last "
             f"position dropped: relative L2 {r} > {CONSIST_TOL}")
        ccfg = dc.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        drops = (f"; cf {cfg.capacity_factor:g}: {int(lost.sum())} "
                 f"choices dropped, {n_last} at a row's last position "
                 f"({'unsound' if n_last else 'sound'}, {r:.1e}); "
                 f"checked at cf {ccfg.capacity_factor:g}")
    rel = decode_consistency(torch, params, ccfg, x)[2]
    need(rel["sound"] <= CONSIST_TOL,
         f"{arch}: prefill vs prefill + decode_step relative L2 {rel} > "
         f"{CONSIST_TOL}")

    timing = []
    for g, B, S in groups:
        xg = torch.as_tensor(prompts[g], device=DEV)
        timing.append(f"{g}+{LM_NEW} " + lm_timing(
            torch, lambda: prefill(params, {"tokens": xg}, cfg,
                                   S + LM_NEW),
            lambda cache: decode_step(params, xg[:, -1:], cache, cfg),
            lm_bounds(cfg, B, S)))
    del params
    torch.cuda.empty_cache()

    # the same consistency in f32, where prefill and decode agree to
    # summation order and each planted fault must land over the limit
    cfg32 = dc.replace(ccfg, dtype=torch.float32,
                       n_layers=f32_layers or cfg.n_layers)
    params = init_params(cfg32, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    rel32 = decode_consistency(torch, params, cfg32, x)[2]
    faults = min(v for k, v in rel32.items() if k != "sound")
    need(rel32["sound"] <= CONSIST_TOL_F32 < faults,
         f"{arch} f32 prefill vs prefill + decode_step: {rel32}, limit "
         f"{CONSIST_TOL_F32} (sound under it, planted faults over it)")
    del params
    torch.cuda.empty_cache()
    depth = f" {f32_layers}L" if f32_layers else ""
    out(f"  {arch} bf16: {n / 1e9:.4f} B params = config, "
          f"{peak:.2f} GiB{predicted}, "
          f"sm90 {per}/prefill, rerun same; " + "; ".join(timing)
          + f"; {gc} pre/dec bf16 {rel['sound']:.1e} < "
          f"{CONSIST_TOL:g} (" + _faults(rel, 1) + f"), f32{depth} "
          f"{rel32['sound']:.1e} < {CONSIST_TOL_F32:g} < "
          + _faults(rel32, 1) + drops, flush=True)
    return launches, got["sm90"]


def lm_timing(torch, run_prefill, decode_from, bounds) -> str:
    """Host ms of ``run_prefill()`` and of a decode step
    (``decode_from(cache)()`` from its cache), each beside its bound and
    the device's busy ms and launches (torch.profiler) -> "prefill P ms
    (bound, busy, launches) decode D (bound, busy, launches)"."""
    ms_pre = host_ms(torch, run_prefill, 3)
    _, cache = run_prefill()

    def run_decode():
        return decode_from(cache)

    ms_dec = host_ms(torch, run_decode, LM_NEW - 1)
    pre = device_times(torch, run_prefill, 1)
    dec = device_times(torch, run_decode, 4)
    b_pre, b_dec = bounds
    return (f"pre {ms_pre:.2f} ms (bound {b_pre:.3f} busy "
            f"{sum(u for _, u in pre.values()) / 1e3:.2f}, "
            f"{sum(c for c, _ in pre.values())} l) dec "
            f"{ms_dec:.3f} ({b_dec:.3f} "
            f"{sum(u for _, u in dec.values()) / 4e3:.3f}, "
            f"{sum(c for c, _ in dec.values()) / 4:.0f})")


def vlm_positions(np, group: str, B: int, S: int, layout=VLM_IMAGE):
    """(B, S, 3) int64 M-RoPE (t, h, w) positions of a prompt group:
    "text": t = h = w = arange; "image": ``layout`` = (n, g): n text
    tokens, a g x g patch grid at t = n with h = n + row and w = n +
    column, then text from the largest position so far + 1 (n + g), as
    Qwen2-VL's rope index lays a prompt out."""
    if group == "text":
        pos = np.repeat(np.arange(S)[:, None], 3, 1)
    else:
        n, g = layout
        row, col = np.divmod(np.arange(g * g), g)
        img = np.stack([np.zeros(g * g, np.int64), row, col], 1) + n
        after = np.arange(S - n - g * g) + n + g
        pos = np.concatenate([np.repeat(np.arange(n)[:, None], 3, 1), img,
                              np.repeat(after[:, None], 3, 1)])
    return np.ascontiguousarray(np.broadcast_to(pos, (B, S, 3)))


def lm_generate(torch, params, cfg, prompt, new: int, enc_input=None,
                positions=None):
    """Greedy tokens (B, S + new) on the parameters' device: the
    engine's generate (with ``enc_input`` for the encoder-decoder), or
    for an M-RoPE config, whose (B, S, 3) ``positions`` generate cannot
    take, prefill with them (numpy: the host copy that picks the flash
    route) and decode_step on each argmax, the reference's VLM path."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serve.engine import generate

    if not cfg.mrope:
        return generate(params, cfg, prompt, new, enc_input=enc_input)
    x = torch.as_tensor(prompt, device=params.device)
    logits, cache = prefill(params, {"tokens": x, "positions": positions},
                            cfg, x.shape[1] + new)
    toks = [x]
    for t in range(new):
        cur = logits[:, -1].argmax(-1, keepdim=True)
        toks.append(cur)
        if t < new - 1:
            logits, cache = decode_step(params, cur, cache, cfg)
    return torch.cat(toks, dim=1)


def lm_encdec_vlm(torch, np):
    """The lm families phase, its encoder-decoder and VLM part, at full
    width in bf16 (seeded random weights made on the card):
    whisper-large-v3 (all 64 layers) generates for LM_ENCDEC_BATCH with
    seeded frame embeddings, and qwen2-vl-72b (LM_VLM_LAYERS of its 80
    layers) greedily decodes each LM_VLM_GROUPS prompt through prefill
    and decode_step; counters reset just before each run and read just
    after (flash sm90 launches a prefill: whisper's 32 encoder layers,
    every key visible, and 32 decoder layers; qwen2-vl's 8 layers on text
    prompts, none on image prompts, whose patches share a t). Then
    parameters = param_count(), the same tokens on a rerun, prefill vs
    prefill[:-1] + decode_step in bf16 and, with the planted faults
    (whisper "enc-row", "pe+1"; qwen2-vl "mrope-h+1", "kv@idx-1", on the
    image prompt with its last token at S - 1 on all three streams), in
    f32, ms and bounds per prefill and decode step, busy ms, launches and
    peak GiB. -> (launches by path, flash launches by route)."""
    import dataclasses as dc

    import repro_torch.kernels as kernels
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.models.model import (decode_step, encode, init_params,
                                          prefill)

    launches, routes = {}, dict.fromkeys(fa.ROUTES, 0)

    def build(cfg):
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                             DEV)
        n = sum(t.numel() for t in params.parameters())
        need(n == cfg.param_count(), f"{cfg.name}: {n} parameters, config "
                                     f"{cfg.param_count()}")
        return params, n

    def run(name, cfg, params, prompt, flash, **extra):
        """Greedy tokens of one prompt with the counters reset before and
        read after; ``flash`` sm90 launches wanted; the prompt kept, the
        tokens in range and the same on a rerun."""
        kernels.reset_launches()
        toks = lm_generate(torch, params, cfg, prompt, LM_NEW, **extra)
        torch.cuda.synchronize()
        launches[name] = check_launches(name, kernels.launch_counts())
        got = dict(fa.flash_attention.route_launches)
        need(got == {"sm90": flash, "cuda_core": 0},
             f"{name}: flash routes {got} in one bf16 prefill, want sm90 "
             f"{flash}")
        routes["sm90"] += flash
        B, S = prompt.shape
        need(toks.shape == (B, S + LM_NEW) and bool(((toks >= 0) & (
            toks < cfg.vocab)).all()) and torch.equal(
                toks[:, :S].cpu(), torch.from_numpy(prompt)),
             f"{name}: tokens out of shape or range, or prompt changed")
        need(torch.equal(lm_generate(torch, params, cfg, prompt, LM_NEW,
                                     **extra), toks),
             f"{name}: a second run gave other tokens")

    def f32_consistency(cfg, x, **kw):
        """prefill vs prefill + decode_step in f32 at full width: sound
        under CONSIST_TOL_F32 (M-RoPE: CONSIST_TOL_F32_VLM), each planted
        fault over it. -> (the relative L2 distances, the limit)"""
        tol = CONSIST_TOL_F32_VLM if cfg.mrope else CONSIST_TOL_F32
        cfg32 = dc.replace(cfg, dtype=torch.float32)
        params = init_params(cfg32, torch.Generator(device=DEV).manual_seed(0),
                             DEV)
        if "enc" in kw:
            kw["enc"] = encode(params, kw["enc"], cfg32)
        rel = decode_consistency(torch, params, cfg32, x, **kw)[2]
        faults = min(v for k, v in rel.items() if k != "sound")
        need(rel["sound"] <= tol < faults,
             f"{cfg.name} f32 prefill vs prefill + decode_step: {rel}, "
             f"limit {tol} (sound under it, faults over it)")
        del params, kw
        torch.cuda.empty_cache()
        return rel, tol

    # whisper-large-v3: the encoder over seeded frames, then the decoder
    n_l = FAMILY_LAYERS[LM_ENCDEC]
    cfg = dc.replace(get_config(LM_ENCDEC), n_layers=n_l, encoder_layers=n_l)
    g, B, S = LM_ENCDEC_BATCH
    params, n = build(cfg)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab, (B, S))
    frames = torch.as_tensor(rng.standard_normal(
        (B, cfg.encoder_ctx, cfg.d_model), dtype=np.float32), device=DEV)
    per = cfg.encoder_layers + cfg.n_layers
    run(f"lm {LM_ENCDEC}", cfg, params, prompt, per, enc_input=frames)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    x = torch.as_tensor(prompt, device=DEV)
    enc = encode(params, frames, cfg)
    rel = decode_consistency(torch, params, cfg, x, enc=enc)[2]
    need(rel["sound"] <= CONSIST_TOL, f"{LM_ENCDEC}: prefill vs prefill + "
                                      f"decode_step {rel} > {CONSIST_TOL}")
    timing = lm_timing(
        torch, lambda: prefill(params, {"tokens": x, "enc_input": frames},
                               cfg, S + LM_NEW),
        lambda cache: decode_step(params, x[:, -1:], cache, cfg, enc=enc),
        lm_bounds(cfg, B, S))
    del params, enc
    torch.cuda.empty_cache()
    rel32, tol = f32_consistency(cfg, x, enc=frames)
    print(f"  {LM_ENCDEC} bf16: {n / 1e9:.4f} B params = config, "
          f"{peak:.2f} GiB, sm90 "
          f"{per}/prefill ({cfg.encoder_layers} all keys + {cfg.n_layers} "
          f"causal), rerun same; {g}+{LM_NEW}, encoder "
          f"{cfg.encoder_ctx} frames: {timing}; pre/dec bf16 "
          f"{rel['sound']:.1e} < {CONSIST_TOL:g} (" + _faults(rel, 1)
          + f"), f32 {rel32['sound']:.1e} < {tol:g} < "
          + _faults(rel32, 1), flush=True)

    # qwen2-vl-72b, LM_VLM_LAYERS layers: text and image prompt groups
    cfg = dc.replace(get_config(LM_VLM), n_layers=LM_VLM_LAYERS)
    params, n = build(cfg)
    rng = np.random.default_rng(2)
    timing = []
    for g, B, S in LM_VLM_GROUPS:
        prompt = rng.integers(0, cfg.vocab, (B, S))
        pos = vlm_positions(np, g, B, S)
        run(f"lm {LM_VLM} {g}", cfg, params, prompt,
            cfg.n_layers if g == "text" else 0, positions=pos)
        t = pos[0, :, 0]
        pairs = int((t[None, :] <= t[:, None]).sum())
        x = torch.as_tensor(prompt, device=DEV)
        timing.append(f"{g} B{B}xS{S}+{LM_NEW} " + lm_timing(
            torch, lambda: prefill(params, {"tokens": x, "positions": pos},
                                   cfg, S + LM_NEW),
            lambda cache: decode_step(params, x[:, -1:], cache, cfg),
            lm_bounds(cfg, B, S, pairs)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the consistency prompt: the image group's, its last token at S - 1
    # on all three streams, where decode_step places it
    pos = pos.copy()
    pos[:, -1] = S - 1
    rel = decode_consistency(torch, params, cfg, x, positions=pos)[2]
    need(rel["sound"] <= CONSIST_TOL, f"{LM_VLM}: prefill vs prefill + "
                                      f"decode_step {rel} > {CONSIST_TOL}")
    del params
    torch.cuda.empty_cache()
    rel32, tol = f32_consistency(cfg, x, positions=pos)
    print(f"  {LM_VLM} {cfg.n_layers} of 80 layers bf16: {n:,} params = "
          f"config, {peak:.2f} GiB, sm90 text {cfg.n_layers} / image 0 a "
          f"prefill, reruns same; " + "; ".join(timing) + "; image prefill "
          f"vs decode bf16 {rel['sound']:.1e} < {CONSIST_TOL:g} ("
          + _faults(rel, 1) + f"), f32 {rel32['sound']:.1e} < {tol:g} < "
          + _faults(rel32, 1), flush=True)
    return launches, routes


# ------------------------------------------------------------ phase 5c

@contextlib.contextmanager
def row_path():
    """Send jit_train_step's gradient down the "rows" path (a dp row a
    device) for as long as the block lasts, counted as such: the row
    path's time on the same grid, beside the "model" path's."""
    import repro_torch.train.train_step as ts
    from repro_torch.models import model as lm

    taken = ts.train_path

    def rows(params, cfg, ctx=None):
        lm.path_counts["rows"] += 1
        return "rows"

    ts.train_path = rows
    try:
        yield
    finally:
        ts.train_path = taken


@contextlib.contextmanager
def plain_flash(fa):
    """Run ``FlashAttention`` through the plain forward (with its LSE)
    and the plain backward, on any device, for as long as the block
    lasts: the comparison the kernels are held to in the train step."""
    fwd, bwd = fa.flash_attention, fa.flash_attention_bwd

    def forward(q, k, v, causal=True, lse=False, q_offset=0):
        return fa.flash_attention_plain(q, k, v, causal, lse, q_offset)

    def backward(q, k, v, out, dout, lse, causal=True, q_offset=0):
        return fa.flash_attention_bwd_plain(q, k, v, dout, lse, causal,
                                            q_offset)

    fa.flash_attention, fa.flash_attention_bwd = forward, backward
    try:
        yield
    finally:
        fa.flash_attention, fa.flash_attention_bwd = fwd, bwd


def planted_bwd(torch, q, k, v, dout, lse, causal, fault):
    """flash_attention_bwd_plain's steps with one planted fault: "delta=0"
    (delta set to zero), "one-head" (dK and dV from the first query head
    of each GQA group alone) or "no-diag" (the diagonal key hidden)."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    rep, scale = H // K, hd ** -0.5
    q5, do5 = q.reshape(B, K, rep, S, hd), dout.reshape(B, K, rep, S, hd)
    s = torch.einsum("bkrqd,bksd->bkrqs", q5.float(), k.float()) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril(
            -1 if fault == "no-diag" else 0)
        s = s.masked_fill(~keep, -1e9)
    w = torch.exp(s - lse.reshape(B, K, rep, S, 1)).to(v.dtype)
    dw = torch.einsum("bkrqd,bksd->bkrqs", do5, v)
    delta = 0.0 if fault == "delta=0" else (dw.float() * w.float()).sum(
        -1, keepdim=True)
    ds = (w.float() * (dw.float() - delta) * scale).to(q.dtype)
    heads = slice(0, 1) if fault == "one-head" else slice(None)
    dv = torch.einsum("bkrqs,bkrqd->bksd", w[:, :, heads], do5[:, :, heads])
    dk = torch.einsum("bkrqs,bkrqd->bksd", ds[:, :, heads], q5[:, :, heads])
    dq = torch.einsum("bkrqs,bksd->bkrqd", ds, k).reshape(B, H, S, hd)
    return dq, dk, dv


def _rel_l2(torch, got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


def bwd_bound_ms(B, H, K, S, hd, causal, nbytes_el, rate):
    """The least ms of the backward: q, k, v, o, do read and dq, dk, dv
    written once, the lse read once, against its five products (s, dp,
    dv, dk, dq: 2 hd operations each) over the attended pairs."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    nbytes = nbytes_el * B * S * hd * (4 * H + 4 * K) + 4 * B * H * S
    return max(nbytes / HBM_BPS, 10 * hd * pairs / rate) * 1e3, nbytes, \
        10 * hd * pairs


def check_flash_bwd(torch, np) -> dict:
    """Phase 5c, first part: the flash backward against its plain version
    on the card at BWD_SHAPES in bf16 and f32 (inputs and the output
    gradient the (B, S, H, hd) views training passes), each call on its
    route (kernels/flash_attention.py:route: sm90 for bf16 at hd 16, 64
    and 128, cuda_core otherwise) and on it alone; the sm90 route against
    the cuda_core one on the same inputs; the forward's LSE on its route
    against the plain LSE; a rerun bit for bit; the planted faults over
    the f32 limit on the cuda_core route and over the bf16 limit on the
    sm90 one; and device / plain / library ms beside the bound, both bf16
    routes at qwen3's shapes (library: the backward kernels of
    scaled_dot_product_attention with enable_gqa, every kernel its
    autograd.grad launches; device: the span in which the route's kernels
    run, kernel_span_ms, since the sm90 route runs two side by side)."""
    import torch.nn.functional as F

    import repro_torch.kernels.flash_attention as fa
    from repro_torch.kernels import build

    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    rng = np.random.default_rng(29)
    rows, text, lse_worst, faults = [], [], 0.0, {}
    worst = dict.fromkeys(("f32", "sm90", "cuda_core", "sm90 vs cuda_core"),
                          0.0)
    launchers = {"sm90": fa.launch_bwd_sm90,
                 "cuda_core": fa.launch_bwd_cuda_core,
                 "f32": fa.launch_bwd_cuda_core}
    for where, B, H, K, S, hd, causal, dtypes in BWD_SHAPES:
        arrs = [torch.from_numpy(rng.standard_normal(
            (B, S, n, hd), dtype=np.float32)).to(DEV) for n in (H, K, K, H)]
        for dt in dtypes:
            q, k, v, do = (x.to(dts[dt]).transpose(1, 2) for x in arrs)
            r = fa.route(q.dtype, hd)
            before = dict(fa.flash_attention.route_launches)
            out, lse = fa.flash_attention(q, k, v, causal, lse=True)
            need(fa.flash_attention.route_launches
                 == {**before, r: before[r] + 1},
                 f"flash_attention {where} {dt}: not one {r} launch")
            _, lse_p = fa.flash_attention_plain(q.float(), k.float(),
                                                v.float(), causal, lse=True)
            el = float((lse - lse_p).abs().max())
            need(el <= LSE_TOL, f"{where} {dt} ({r}) LSE vs plain: {el}")
            lse_worst = max(lse_worst, el)
            n0 = fa.flash_attention_bwd.launches
            r0 = dict(fa.flash_attention_bwd.route_launches)
            got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal)
            again = fa.flash_attention_bwd(q, k, v, out, do, lse, causal)
            want = fa.flash_attention_bwd_plain(q, k, v, do, lse, causal)
            torch.cuda.synchronize()
            need(fa.flash_attention_bwd.launches == n0 + 2
                 and fa.flash_attention_bwd.route_launches
                 == {**r0, r: r0[r] + 2},
                 f"flash_attention_bwd {where} {dt}: not one {r} launch a "
                 f"call ({r0} -> {fa.flash_attention_bwd.route_launches})")
            need(all(torch.equal(a, b) for a, b in zip(got, again)),
                 f"flash_attention_bwd {where} {dt}: a rerun differs")
            need(all(g.shape == t.shape and g.dtype == t.dtype
                     and g.stride() == t.stride()
                     for g, t in zip(got, (q, k, v))),
                 f"flash_attention_bwd {where} {dt}: shape, dtype or layout")
            e = max(_rel_l2(torch, g, w) for g, w in zip(got, want))
            need(e <= BWD_TOL[dt], f"flash_attention_bwd {where} {dt} ({r}): "
                                   f"rel L2 {e} > {BWD_TOL[dt]}")
            mode = "f32" if dt == "f32" else r
            worst[mode] = max(worst[mode], e)
            timed = [(mode, e)]
            per_call = {mode: 3}
            if r == "sm90":
                cc = fa.launch_bwd_cuda_core(q, k, v, out, do, lse, causal)
                e_cc = max(_rel_l2(torch, g, w) for g, w in zip(got, cc))
                need(e_cc <= BWD_TOL[dt], f"flash_attention_bwd {where}: sm90 "
                                          f"vs cuda_core rel L2 {e_cc}")
                worst["sm90 vs cuda_core"] = max(worst["sm90 vs cuda_core"],
                                                 e_cc)
                if where in LM_GROUPS:
                    timed.append(("cuda_core", max(
                        _rel_l2(torch, g, w) for g, w in zip(cc, want))))
                    per_call["cuda_core"] = 3
                plan = fa.bwd_plan_sm90(B, H, K, S, causal,
                                        build.sm_count(q.device.index))
                per_call["sm90"] = 3 + (plan["groups"] > 1)
                level_line(f"flash_attention_bwd sm90 plan {where}: "
                           f"{plan['groups']} head group(s); " + "; ".join(
                               f"{role} {p['tile'][0]}x{p['tile'][1]} "
                               f"tiles, {p['blocks']} blocks "
                               f"({p['waves']:.2f} waves, "
                               f"{p['blocks_per_sm']} an SM), steps longest "
                               f"{p['longest_steps']} mean "
                               f"{p['mean_steps']:.1f}"
                               for role, p in (("dK/dV", plan["dkdv"]),
                                               ("dQ", plan["dq"]))))
            if where == BWD_FAULT_SHAPES.get(dt):
                faults[dt] = {}
                for fault in ("delta=0", "one-head", "no-diag"):
                    bad = planted_bwd(torch, q, k, v, do, lse, causal, fault)
                    faults[dt][fault] = max(_rel_l2(torch, g, w)
                                            for g, w in zip(got, bad))
                need(min(faults[dt].values()) > BWD_TOL[dt],
                     f"a planted backward fault stays under the {dt} limit "
                     f"on the {r} route: {faults[dt]}")
            if where not in BWD_TIMED:
                continue
            ql, kl, vl = (x.detach().contiguous().requires_grad_(True)
                          for x in (q, k, v))
            out_l = F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=causal, enable_gqa=True)

            def library():
                return torch.autograd.grad(out_l, (ql, kl, vl), do,
                                           retain_graph=True)

            def plain():
                return fa.flash_attention_bwd_plain(q, k, v, do, lse, causal)

            rate = BF16_FLOPS if dt == "bf16" else F32_FLOPS
            bound, nbytes, ops = bwd_bound_ms(B, H, K, S, hd, causal,
                                              q.element_size(), rate)
            for m, e_m in timed:
                def kernel(run=launchers[m]):
                    return run(q, k, v, out, do, lse, causal)

                if where in LM_GROUPS:
                    rows.append(timed_row(
                        torch, "flash_attention_bwd", where,
                        (B, H, K, S, hd), m, e_m, kernel, plain, library,
                        nbytes, ops / rate, "flash_attention_bwd",
                        span=True))
                else:
                    dev, lib = (kernel_span_ms(torch, fn, sym) for fn, sym
                                in ((kernel, "flash_attention_bwd"),
                                    (library, "")))
                    text.append(f"{where} {m} " + "/".join(
                        "-" if t is None else f"{t:.4g}"
                        for t in (dev, cuda_ms(plain, reps=5), lib))
                        + f" ({bound:.3g})")
                level_line(f"flash_attention_bwd {where} {m} timing, "
                           f"kernel: " + timing_probe(
                               torch, kernel, "flash_attention_bwd",
                               per_call[m]))
            level_line(f"flash_attention_bwd {where} {dt} timing, SDPA: "
                       + timing_probe(torch, library, ""))
    planted = "; ".join(f"{BWD_FAULT_SHAPES[dt]} {dt}: "
                        + _faults(dict(faults[dt], sound=0), 1)
                        for dt in ("f32", "bf16"))
    level_line(f"flash_attention_bwd planted faults: {planted}")
    # the detail on standard error (the kernels line carries qwen3's)
    level_line(f"  flash_attention_bwd vs plain, rel L2 f32 "
               f"{worst['f32']:.1e} (tol {BWD_TOL['f32']:g}), bf16 sm90 "
               f"{worst['sm90']:.1e} / cuda_core {worst['cuda_core']:.1e} "
               f"(tol {BWD_TOL['bf16']:g}), sm90 vs cuda_core "
               f"{worst['sm90 vs cuda_core']:.1e}; one route launch a call, "
               f"reruns equal; LSE {lse_worst:.1e} (tol {LSE_TOL:g}); "
               f"planted faults over both limits (least "
               f"{min(min(f.values()) for f in faults.values()):.2f}); sm90 "
               f"device span/plain/SDPA-bwd ms (bound): " + "; ".join(text))
    print(f"  flash_attention_bwd vs plain: rel L2 f32 {worst['f32']:.1e}, "
          f"bf16 sm90 {worst['sm90']:.1e}, cuda_core "
          f"{worst['cuda_core']:.1e}; faults over both limits", flush=True)
    out = summarize(rows, ("flash_attention_bwd",), list(LM_GROUPS), 1)
    out["flash_attention_bwd"]["max_abs_err"] = max(
        worst[m] for m in ("f32", "sm90", "cuda_core"))
    return out


def train_batch(np, cfg, B: int, S: int, seed: int = 0) -> dict:
    """One lm_data batch (tokens, labels (B, S)) for ``cfg``, with
    whisper's seeded frame embeddings and qwen2-vl's text positions."""
    from repro_torch.data.lm_data import LMDataConfig, batches

    batch = dict(next(batches(LMDataConfig(vocab=cfg.vocab, seq_len=S,
                                           batch=B, seed=seed))))
    if cfg.encoder_layers:
        batch["enc_input"] = np.random.default_rng(seed).standard_normal(
            (B, cfg.encoder_ctx, cfg.d_model), dtype=np.float32)
    if cfg.mrope:
        batch["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3)).copy()
    return batch


def lm_train(torch, np):
    """Phase 5c: LM training. The backward kernel's checks
    (check_flash_bwd); qwen3-14b at full width with TRAIN_LAYERS layers in
    bf16 on an lm_data batch: the gradient with the kernels against the
    plain forward and backward on the card, then TRAIN_STEPS AdamW steps
    of make_train_step on that one batch with the launch counters reset
    just before and read just after (loss finite and falling), ms a step,
    busy ms, launches, peak GiB; each family at smoke size in f32, card
    against CPU (loss, gradients, one step's parameters) and a DDP step
    with compression over 2 logical devices; the train CLI at smoke size
    in subprocesses: SIGTERM, then resume, the same losses as an
    uninterrupted run."""
    import dataclasses as dc

    import repro_torch.kernels as kernels
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.kernels import build
    from repro_torch.models.model import loss_fn, trainable
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import (init_train_state,
                                              make_ddp_train_step,
                                              make_train_step)

    summary = check_flash_bwd(torch, np)

    cfg = dc.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    B, S = TRAIN_BATCH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator(device=DEV).manual_seed(0),
                             DEV)
    params = state["params"]
    n = sum(t.numel() for t in params.parameters())
    need(n == cfg.param_count(), f"{n} parameters, config "
                                 f"{cfg.param_count()}")
    batch = train_batch(np, cfg, B, S)
    dev_batch = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}

    def grads_once():
        loss = loss_fn(params, dev_batch, cfg)
        loss.backward()
        g = {k: p.grad for k, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return float(loss.detach()), g

    kernels.reset_launches()
    loss_k, g_k = grads_once()
    once = kernels.launch_counts()
    once_bwd = dict(fa.flash_attention_bwd.route_launches)
    need(once["flash_attention"] == 2 * TRAIN_LAYERS
         and once["flash_attention_bwd"] == TRAIN_LAYERS
         and once_bwd == {"sm90": TRAIN_LAYERS, "cuda_core": 0},
         f"one gradient launched flash {once['flash_attention']} forward "
         f"and {once_bwd} backward, want {2 * TRAIN_LAYERS} and "
         f"{TRAIN_LAYERS} on sm90")
    with plain_flash(fa):
        loss_p, g_p = grads_once()
    # each leaf on its own, so that the embedding's and the head's 1.56 B
    # entries, whose gradient no attention backward reaches, dilute no
    # fault of a layer's; the whole is printed beside it
    num = den = 0.0
    leaf = {}
    for k in g_k:
        d = float((g_k[k].float() - g_p[k].float()).square().sum())
        r = float(g_p[k].float().square().sum())
        num, den = num + d, den + r
        if r > 0:
            leaf[k] = math.sqrt(d / r)
    grel = math.sqrt(num / den)
    worst_leaf = max(leaf, key=leaf.get)
    need(leaf[worst_leaf] <= TRAIN_GRAD_TOL and abs(loss_k - loss_p)
         <= TRAIN_LOSS_TOL * abs(loss_p),
         f"train gradient kernels vs plain: rel L2 {leaf[worst_leaf]} at "
         f"{worst_leaf}, loss {loss_k} vs {loss_p}")
    attn = [v for k, v in leaf.items()
            if k.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wo")]
    del g_k, g_p

    step = make_train_step(cfg, OptConfig(lr=TRAIN_LR, warmup_steps=1,
                                          total_steps=TRAIN_STEPS))
    name = f"lm train {LM_ARCH}"
    kernels.reset_launches()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, dev_batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    launches = check_launches(name, kernels.launch_counts())
    routes = dict(fa.flash_attention.route_launches)
    bwd_routes = dict(fa.flash_attention_bwd.route_launches)
    need(launches["flash_attention"] == 2 * TRAIN_LAYERS * TRAIN_STEPS
         and routes == {"sm90": 2 * TRAIN_LAYERS * TRAIN_STEPS,
                        "cuda_core": 0}
         and launches["flash_attention_bwd"] == TRAIN_LAYERS * TRAIN_STEPS
         and bwd_routes == {"sm90": TRAIN_LAYERS * TRAIN_STEPS,
                            "cuda_core": 0},
         f"{TRAIN_STEPS} steps launched flash {routes} forward and "
         f"{bwd_routes} backward")
    need(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
         f"train losses {losses}: not finite and falling")
    print(launch_line({name: launches}), flush=True)

    ms = host_ms(torch, lambda: step(state, dev_batch), 2)
    times = device_times(torch, lambda: step(state, dev_batch), 1)
    busy = sum(t for _, t in times.values()) / 1e3
    n_launch = sum(c for c, _ in times.values())
    n_bwd = sum(c for k, (c, _) in times.items()
                if "flash_attention_bwd" in k)
    plan = fa.bwd_plan_sm90(B, cfg.n_heads, cfg.n_kv_heads, S, True,
                            build.sm_count(torch.cuda.current_device()))
    level_line(f"{name} step profile: {n_bwd} flash_attention_bwd kernel "
               f"launches ({3 + (plan['groups'] > 1)} a call on the sm90 "
               f"route, {TRAIN_LAYERS} calls); clocks [{gpu_clocks()}]")
    f_ms = sum(t for k, (_, t) in times.items()
               if "flash_attention_kernel" in k) / 1e3
    b_ms = sum(t for k, (_, t) in times.items()
               if "flash_attention_bwd" in k) / 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    T = B * S
    D, V, H, K, hd = cfg.d_model, cfg.vocab, cfg.n_heads, cfg.n_kv_heads, \
        cfg.hd
    layer = D * hd * (2 * H + 2 * K) + 3 * D * cfg.d_ff   # its matmuls
    pairs = B * H * S * (S + 1) // 2
    # the step's own work: each layer's and the head's matmuls forward and
    # backward (6 N T), attention 4 hd a pair forward and 10 hd backward;
    # the remat recompute (each layer's forward again, 2 N T + 4 hd a
    # pair) is a memory choice and stands beside the bound, not in it
    flops = TRAIN_LAYERS * (6 * layer * T + 14 * hd * pairs) \
        + 6 * D * V * T
    remat = TRAIN_LAYERS * (2 * layer * T + 4 * hd * pairs)
    # AdamW: bf16 grad and param, f32 m, v, master read and written
    adam_bytes = n * (2 + 2 + 2 * 12)
    bound = (flops / BF16_FLOPS + adam_bytes / HBM_BPS) * 1e3
    print(f"  {name} full width, {TRAIN_LAYERS} of 40 layers ({n:,} "
          f"parameters), bf16, lm_data B{B}xS{S}: grad kernels vs plain rel "
          f"L2 worst leaf {leaf[worst_leaf]:.1e} ({worst_leaf}; tol "
          f"{TRAIN_GRAD_TOL:g}), attention leaves {min(attn):.1e}-"
          f"{max(attn):.1e}, all {grel:.1e}, loss {loss_k:.4f} vs "
          f"{loss_p:.4f}; {TRAIN_STEPS} AdamW steps loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; {ms:.1f} ms/step (bound {bound:.1f} = matmuls "
          f"{flops / BF16_FLOPS * 1e3:.1f} + AdamW "
          f"{adam_bytes / HBM_BPS * 1e3:.1f}; remat +"
          f"{remat / BF16_FLOPS * 1e3:.1f}), {T / ms * 1e3:.0f} tok/s, "
          f"busy {busy:.1f} ms, {n_launch} launches, flash fwd {f_ms:.2f} ms "
          f"({2 * TRAIN_LAYERS} launches) bwd {b_ms:.2f} ms ({TRAIN_LAYERS} "
          f"sm90, kernel sum), "
          f"peak "
          f"{peak:.2f} GiB", flush=True)
    del state, params, dev_batch, step
    torch.cuda.empty_cache()

    # every family at smoke size in f32: card against CPU
    text = []
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for arch in TRAIN_FAMILIES:
        scfg = dc.replace(get_config(arch, smoke=True), dtype=torch.float32)
        leaves = smoke_leaves(np, scfg, 0)
        sbatch = train_batch(np, scfg, *TRAIN_SMOKE_BATCH)
        res = {}
        for dev in (DEV, "cpu"):
            p = trainable(lm_params_from_numpy(leaves, scfg, dev))
            loss = loss_fn(p, sbatch, scfg)
            loss.backward()
            g = {k: t.grad.cpu() if t.grad is not None
                 else torch.zeros_like(t, device="cpu")
                 for k, t in p.named_parameters()}
            for t in p.parameters():
                t.grad = None
            st = {"params": p,
                  "opt": init_opt_state(dict(p.named_parameters()))}
            make_train_step(scfg, opt)(st, sbatch)
            res[dev] = (float(loss.detach()), g,
                        {k: t.detach().cpu() for k, t in p.named_parameters()})
        (lc, gc_, pc), (lh, gh, ph) = res[DEV], res["cpu"]
        dl = abs(lc - lh) / abs(lh)
        dg = max(_rel_l2(torch, gc_[k], gh[k]) for k in gh
                 if float(gh[k].norm()) > 0)
        dp = max(_rel_l2(torch, pc[k], ph[k]) for k in ph)
        need(dl <= TRAIN_SMOKE_TOL["loss"] and dg <= TRAIN_SMOKE_TOL["grads"]
             and dp <= TRAIN_SMOKE_TOL["params"],
             f"{arch} smoke train card vs CPU: loss {dl}, grads {dg}, "
             f"params {dp}")
        text.append(f"{arch.split('-')[0]} {dl:.0e}/{dg:.0e}/{dp:.0e}")

    # a DDP step with int8 compression over 2 logical devices
    scfg = dc.replace(get_config(LM_ARCH, smoke=True), dtype=torch.float32)
    leaves = smoke_leaves(np, scfg, 0)
    sbatch = train_batch(np, scfg, 4, TRAIN_SMOKE_BATCH[1])
    res = {}
    os.environ["REPRO_TEST_DEVICES"] = "2"
    try:
        for dev in (DEV, "cpu"):
            p = trainable(lm_params_from_numpy(leaves, scfg, dev))
            named = dict(p.named_parameters())
            st = {"params": p, "opt": init_opt_state(named),
                  "residual": [{k: torch.zeros(t.shape, device=t.device)
                                for k, t in named.items()}
                               for _ in range(2)]}
            st, m = make_ddp_train_step(scfg, opt, compress=True)(st, sbatch)
            res[dev] = (float(m["loss"]), {k: t.detach().cpu()
                                           for k, t in p.named_parameters()},
                        len(st["residual"]))
    finally:
        os.environ.pop("REPRO_TEST_DEVICES")
    dl = abs(res[DEV][0] - res["cpu"][0]) / abs(res["cpu"][0])
    dp = max(_rel_l2(torch, res[DEV][1][k], res["cpu"][1][k])
             for k in res["cpu"][1])
    need(dl <= TRAIN_SMOKE_TOL["loss"] and dp <= TRAIN_SMOKE_TOL["params"]
         and res[DEV][2] == 2, f"DDP --compress card vs CPU: loss {dl}, "
                               f"params {dp}")
    level_line(f"  train smoke f32 B{TRAIN_SMOKE_BATCH[0]}x"
               f"S{TRAIN_SMOKE_BATCH[1]} card vs CPU, loss/grads/step params "
               "(tol " + "/".join(f"{v:g}" for v in TRAIN_SMOKE_TOL.values())
               + "): " + ", ".join(text) + f"; ddp --compress 2 logical "
               f"devices {dl:.0e}/-/{dp:.0e}")
    level_line("  " + train_cli(), flush=True)
    return {name: launches}, routes, bwd_routes, summary


def train_cli() -> str:
    """The train CLI on the card at smoke size in subprocesses: an
    uninterrupted run; a run stopped by SIGTERM (its final checkpoint);
    the same command again, which resumes. The resumed losses must be the
    uninterrupted run's."""
    import signal
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(SRC))
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            LM_ARCH, "--steps", str(CLI_STEPS), "--batch", "2", "--seq",
            "32"] + (["--device", "cpu"] if DEV == "cpu"
                                         else [])

    def losses(text):
        return {int(ln.split()[1]): ln.split()[3] for ln in text.splitlines()
                if ln.startswith("step ")}

    def run(extra):
        out = subprocess.run(args + extra, capture_output=True, text=True,
                             timeout=300, env=env, cwd=ROOT)
        need(out.returncode == 0, f"train CLI {extra}: {out.stderr[-800:]}")
        return out.stdout

    want = losses(run([]))
    need(sorted(want) == list(range(1, CLI_STEPS + 1)), "train CLI: steps")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck:
        extra = ["--ckpt", ck, "--ckpt-every", "1000"]
        proc = subprocess.Popen(args + extra, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env,
                                cwd=ROOT)
        seen = []
        try:
            for line in proc.stdout:
                seen.append(line)
                if line.startswith("step    2"):
                    proc.send_signal(signal.SIGTERM)
                    break
            rest, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        first = "".join(seen) + rest
        stopped = max(losses(first), default=0)
        need(proc.returncode == 0 and "SIGTERM: writing final checkpoint"
             in first and 2 <= stopped < CLI_STEPS,
             f"train CLI SIGTERM: rc {proc.returncode}, stopped at "
             f"{stopped}: {err[-500:]}")
        again = run(extra)
        got = {**losses(first), **losses(again)}
        need(f"resumed from step {stopped}" in again
             and got == want, f"train CLI resume from {stopped}: losses "
                              f"differ from the uninterrupted run")
    return (f"train CLI {LM_ARCH} smoke bf16 on the card, {CLI_STEPS} "
            f"steps: SIGTERM after step {stopped} (final checkpoint, exit "
            f"0), rerun resumed from step {stopped}; losses of steps 1-"
            f"{CLI_STEPS} = the uninterrupted run's")


def mesh_generate(torch, params, cfg, prompt, new: int, ctx,
                  positions=None, enc=None):
    """Greedy tokens (B, new) and each step's logits (B, new, V) in f32
    through prefill and decode_step under ``ctx`` (None: the local
    path); ``positions``: qwen2-vl's (B, S, 3) prompt positions; ``enc``:
    whisper's encoder states."""
    from repro_torch.models.model import decode_step, prefill

    x = torch.as_tensor(prompt, device=params.device)
    batch = {"tokens": x}
    if positions is not None:
        batch["positions"] = positions
    logits, cache = prefill(params, batch, cfg, x.shape[1] + new, ctx,
                            enc=enc)
    toks, steps = [], []
    for t in range(new):
        steps.append(logits[:, -1].float())
        toks.append(steps[-1].argmax(-1, keepdim=True))
        if t < new - 1:
            logits, cache = decode_step(params, toks[-1], cache, cfg,
                                        enc=enc, ctx=ctx)
    return torch.cat(toks, 1), torch.stack(steps, 1)


def whole_of(torch, sharded):
    """The model that a ShardedLM on logical devices of one card cuts:
    each leaf the storage its pieces view (shard_leaf keeps views there),
    so the whole model costs no memory beside the pieces."""
    from repro_torch.models.model import CausalLM, _nest

    def base(pieces):
        t = pieces[0]._base if pieces[0]._base is not None else pieces[0]
        need(all(p.untyped_storage().data_ptr()
                 == t.untyped_storage().data_ptr() for p in pieces),
             "the pieces of a leaf on logical devices are not its views")
        return t
    return CausalLM(sharded.cfg, _nest(
        (n, base(ps)) for n, ps in sharded.pieces.items()))


def init_matches(torch, cfg, sharded, seed: int = 0) -> int:
    """Every piece of a per-shard init against Sharding.shard of the same
    leaf of the whole init from the same seed, bit for bit, leaf by leaf
    (each leaf drawn again alone, in the whole init's order). -> the
    number of leaves."""
    from repro_torch.models.model import _init_leaves
    from repro_torch.models.sharded import shard_leaf

    n = 0
    gen = torch.Generator(device=DEV).manual_seed(seed)
    for name, t in _init_leaves(cfg, gen, torch.device(DEV)):
        want = shard_leaf(sharded.shardings[name], t)
        need(all(torch.equal(a, b) for a, b in
                 zip(sharded.pieces[name], want)),
             f"{cfg.name}: the per-shard init's {name} differs from the "
             f"whole init's")
        n += 1
        del t, want
    return n


def tokens_to_tie(torch, got, want, want_logits, tie: float) -> str:
    """Greedy tokens ``got`` against ``want`` (B, new): equal, or equal up
    to each row's first difference, where ``want``'s own top-2 margin is
    at most ``tie`` (a near-tie either path may break); fails otherwise.
    -> "=" or "= to t<first>"."""
    first = None
    for b in range(got.shape[0]):
        diff = (got[b] != want[b]).nonzero()
        if not len(diff):
            continue
        t = int(diff[0])
        top2 = want_logits[b, t].topk(2).values
        margin = float(top2[0] - top2[1])
        need(margin <= tie, f"greedy tokens differ at row {b} step {t}, "
                            f"where the local path's top-2 margin "
                            f"{margin:.4f} is over the tie {tie:.4f}")
        first = t if first is None else min(first, t)
    return "=" if first is None else f"= to t{first}"


def mesh_serve(torch, np, arch, layers, shape, B, S, new):
    """One serving cell on a (data, model) grid of logical devices of the
    card, from weights held as shards: ``arch`` at full width (``layers``
    of its layers) in bf16. Smoke size in f32: the whole model's tokens
    on the card equal the CPU's, and the model loaded per shard
    (lm_params_from_numpy(..., shardings)) gives the whole one's logits
    within SHARD_TOL_F32. Full width: init_params per shard, each piece
    against the whole init's bit for bit (init_matches); the sharded
    prefill and a decode step with the launch counters reset just before
    and read just after (a dp row of the batch on each row's device, the
    MoE's all-to-all and replicated paths, flash sm90, each counted);
    sharded against the same weights whole (whole_of) under the same
    ctx: prefill logits within SHARD_TOL, greedy tokens equal up to a
    near-tie. A MoE also: EP against the local path at capacity factor E
    / k (nothing drops) within CONSIST_TOL, tokens up to a near-tie; at
    its own factor, dropped choices per EP shard beside the local path's.
    Prefill and decode-step ms of the sharded, whole-EP and local paths
    in turns, with busy ms, launches and the bound. -> (launches, flash
    routes, stdout line)."""
    import dataclasses as dc

    import repro_torch.kernels as kernels
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.models import moe
    from repro_torch.models.model import (decode_step, init_params,
                                          param_shapes, prefill)
    from repro_torch.sharding.rules import make_ctx, param_shardings

    data, model = shape
    short = arch.split("-")[0]
    # smoke size, f32: the card's tokens = the CPU's; sharded = whole
    scfg = dc.replace(get_config(arch, smoke=True), dtype=torch.float32)
    leaves = smoke_leaves(np, scfg, 0)
    Bs, Ss = MESH_SMOKE_PROMPT
    prompt = np.random.default_rng(1).integers(0, scfg.vocab, (Bs, Ss))
    spos = vlm_positions(np, "text", Bs, Ss) if scfg.mrope else None
    smoke = {}
    for dev in ("cpu", DEV):
        p = lm_params_from_numpy(leaves, scfg, dev)
        ctx = make_ctx(make_host_mesh(model, dev))
        smoke[dev] = mesh_generate(torch, p, scfg, prompt, 8, ctx, spos)
    need(torch.equal(smoke[DEV][0].cpu(), smoke["cpu"][0].cpu()),
         f"{arch} smoke: greedy tokens on a grid differ between the card "
         f"and the CPU")
    sp = lm_params_from_numpy(leaves, scfg, DEV,
                              param_shardings(ctx.grid, p, scfg))
    del p
    st, sl = mesh_generate(torch, sp, scfg, prompt, 8, ctx, spos)
    smoke_rel = float((sl - smoke[DEV][1]).norm() / smoke[DEV][1].norm())
    need(smoke_rel <= SHARD_TOL_F32 and torch.equal(st, smoke[DEV][0]),
         f"{arch} smoke: sharded vs whole logits {smoke_rel} > "
         f"{SHARD_TOL_F32}, or its tokens differ")
    del sp, smoke

    cfg = get_config(arch)
    if layers:
        cfg = dc.replace(cfg, n_layers=layers)
    L = cfg.n_layers
    grid = make_host_mesh(model, DEV)
    need(grid.shape == shape, f"grid {grid.shape}, want {shape}")
    ctx = make_ctx(grid)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sharded = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                          DEV, param_shardings(grid, param_shapes(cfg), cfg))
    init_s = time.perf_counter() - t0
    n_leaves = init_matches(torch, cfg, sharded)
    params = whole_of(torch, sharded)
    x = np.random.default_rng(2).integers(0, cfg.vocab, (B, S))
    pos = vlm_positions(np, "text", B, S) if cfg.mrope else None
    xt = torch.as_tensor(x, device=DEV)
    batch = {"tokens": xt} if pos is None else {"tokens": xt,
                                                "positions": pos}

    kernels.reset_launches()
    moe.reset_paths()
    lm.reset_paths()
    first, cache = prefill(sharded, batch, cfg, S + new, ctx)
    paths_pre = dict(moe.path_counts)
    moe.reset_paths()
    decode_step(sharded, first[:, -1].argmax(-1, keepdim=True), cache, cfg,
                ctx=ctx)
    torch.cuda.synchronize()
    paths_dec = dict(moe.path_counts)
    # over "model" the reference's layout; a "model" axis of 1, the rows
    path = "model" if model > 1 else "rows"
    need(lm.path_counts == {"whole": 0, "rows": 0, "model": 0, path: 2},
         f"{arch} {shape}: prefill and decode_step took the paths "
         f"{lm.path_counts}, want {path} both")
    name = f"lm mesh {short}" + (f" {data}x{model}" if arch in MESH_BY_GRID
                                 else "")
    launches = {name: check_launches(name, kernels.launch_counts())}
    routes = dict(fa.flash_attention.route_launches)
    rows = data
    want_paths = ((L * rows, 0) if cfg.is_moe else (0, 0))
    need(paths_pre == {"local": 0, "a2a": want_paths[0], "replicated": 0}
         and paths_dec == {"local": 0, "a2a": 0,
                           "replicated": want_paths[0]},
         f"{arch}: MoE paths {paths_pre} in the sharded prefill and "
         f"{paths_dec} in a decode step, want a2a and replicated "
         f"{want_paths[0]} each")
    # one launch a layer without a window on each device of each row over
    # "model" (each its chunk at its offset), one a row on the row path
    per = model if path == "model" else 1
    need(routes == {"sm90": flash_layers(cfg) * rows * per, "cuda_core": 0},
         f"{arch}: the sharded prefill launched the flash routes {routes}")
    del first, cache

    # sharded against the same weights whole, under the same ctx; a MoE's
    # sharded run takes the whole run's experts where its own choice
    # differs, and each such choice must be a near-tie (routed)
    (t_wh, l_wh), g_wh = routed(torch, lambda: mesh_generate(
        torch, params, cfg, x, new, ctx, pos))
    (t_sh, l_sh), g_sh = routed(torch, lambda: mesh_generate(
        torch, sharded, cfg, x, new, ctx, pos), g_wh if cfg.is_moe else None)
    flips, ties = routed_flips(torch, g_sh, g_wh, cfg.top_k)
    need(flips == ties, f"{arch}: {flips} expert choices of the sharded run "
                        f"differ from the whole run's, {ties} of them at "
                        f"near-ties")
    del g_sh, g_wh
    shard_rel = float((l_sh[:, 0] - l_wh[:, 0]).norm() / l_wh[:, 0].norm())
    # every step both runs computed from the same tokens (decode over
    # "model" reduces its partial sums across the devices, so its steps
    # are not the whole model's bit for bit): their logits within
    # SHARD_TOL, and the near-tie twice their largest difference
    ok = torch.ones_like(t_sh, dtype=torch.bool)
    ok[:, 1:] = torch.cumprod((t_sh == t_wh).int(), 1)[:, :-1].bool()
    diff = l_sh - l_wh
    step_rel = float(diff.square().sum(-1)[ok].sum().sqrt()
                     / l_wh.square().sum(-1)[ok].sum().sqrt())
    dmax = float(diff.abs().amax(-1)[ok].max())
    per_step = (diff.square().sum(-1) * ok).sum(0).sqrt() / (
        l_wh.square().sum(-1) * ok).sum(0).sqrt().clamp(min=1e-30)
    level_line(f"  lm mesh {short} {shape}: sharded vs whole bf16 rel L2 a "
               f"step (rows of the same tokens): "
               + " ".join(f"{x:.1e}" for x in per_step.tolist()))
    need(max(shard_rel, step_rel) <= SHARD_TOL,
         f"{arch}: sharded vs whole logits: relative L2 {shard_rel} "
         f"(prefill), {step_rel} (every step of the same tokens) > "
         f"{SHARD_TOL}")
    shard_tie = max(2 * dmax, 2.0 ** -4)
    shard_same = tokens_to_tie(torch, t_sh, t_wh, l_wh, shard_tie)
    del l_sh, l_wh, diff

    ep = ""
    if cfg.is_moe:
        # EP against the local path where nothing drops
        cf = cfg.n_experts / cfg.top_k
        ncfg = dc.replace(cfg, capacity_factor=cf)
        t_ep, l_ep = mesh_generate(torch, params, ncfg, x, new, ctx)
        t_lo, l_lo = mesh_generate(torch, params, ncfg, x, new, None)
        rel = float((l_ep[:, 0] - l_lo[:, 0]).norm() / l_lo[:, 0].norm())
        dmax = float((l_ep[:, 0] - l_lo[:, 0]).abs().max())
        need(rel <= CONSIST_TOL, f"{arch}: EP vs local prefill logits at "
                                 f"cf {cf:g}: relative L2 {rel} > "
                                 f"{CONSIST_TOL}")
        tie = max(2 * dmax, 2.0 ** -4)
        same = tokens_to_tie(torch, t_ep, t_lo, l_lo, tie)
        del l_ep, l_lo
        # drops at the config's own capacity factor: one _route call a
        # shard and layer on the EP path, one a layer on the local one
        ep_calls = moe_drops(torch, lambda: prefill(
            params, {"tokens": xt}, cfg, S + new, ctx))[1]
        lo_calls = moe_drops(torch, lambda: prefill(
            params, {"tokens": xt}, cfg, S + new))[1]
        shards = data * model
        per_shard = [int(sum(c.sum() for c in ep_calls[s::shards]))
                     for s in range(shards)]
        lo_drops = int(sum(c.sum() for c in lo_calls))
        ep = (f"a2a/rep {L}/{L}; cf {cf:g} logits {rel:.0e}, tokens "
              f"{same}; cf {cfg.capacity_factor:g} drops {sum(per_shard)} "
              f"(local {lo_drops}); ")
        level_line(f"  {name} {shape}: per-shard dropped choices "
                   f"{per_shard}; tie {tie:.4f}")

    # timing: sharded, whole on the grid (EP for a MoE) and local, in
    # turns
    def runs(p, c):
        return (lambda: prefill(p, batch, cfg, S + new, c),
                lambda cache: decode_step(p, xt[:, -1:], cache, cfg,
                                          ctx=c))
    kinds = (("shard", sharded, ctx), ("whole", params, ctx),
             ("local", params, None))
    if not cfg.is_moe:
        kinds = kinds[::2]
    ms = {k: [] for k, _, _ in kinds}
    for _ in range(2):
        for k, p, c in kinds:
            pre, dec = runs(p, c)
            m_pre = host_ms(torch, pre, 2)
            _, cache = pre()
            ms[k].append((m_pre, host_ms(torch, lambda: dec(cache), 8)))
    busy = {}
    for k, p, c in kinds:
        pre, dec = runs(p, c)
        _, cache = pre()
        tp = device_times(torch, pre, 1)
        td = device_times(torch, lambda: dec(cache), 2)
        busy[k] = (round(sum(u for _, u in tp.values()) / 1e3, 1),
                   sum(n for n, _ in tp.values()),
                   round(sum(u for _, u in td.values()) / 2e3, 1),
                   sum(n for n, _ in td.values()) // 2)
    med = {k: (float(np.median([a for a, _ in v])),
               float(np.median([b for _, b in v]))) for k, v in ms.items()}
    b_pre, b_dec = lm_bounds(cfg, B, S)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    level_line(f"  {name} {shape}: smoke sharded vs whole {smoke_rel:.1e}; "
               f"init {init_s:.1f} s, {n_leaves} leaves = whole init; ms "
               f"rounds {ms}; busy ms, launches (prefill, decode) {busy}; "
               f"peak {peak:.1f} GiB")
    del params, sharded
    torch.cuda.empty_cache()
    order = "/".join(k for k, _, _ in kinds)
    line = (f"  mesh {short}{'' if not layers else f' {layers}L'} "
            f"{data}x{model} {path}: shards = whole: init, logits "
            f"{shard_rel:.0e}/{step_rel:.0e} (tie {shard_tie:.3g}"
            + (f", {flips} near-tie routes pinned" if cfg.is_moe else "")
            + ") "
            f"(f32 {smoke_rel:.0e}), tokens {shard_same}; {ep}ms "
            f"{order}/bound: prefill "
            + "/".join(f"{med[k][0]:.1f}" for k, _, _ in kinds)
            + f"/{b_pre:.2f}, decode "
            + "/".join(f"{med[k][1]:.1f}" for k, _, _ in kinds)
            + f"/{b_dec:.2f}")
    return launches, routes, line


def mesh_encdec(torch, np, shape):
    """whisper-large-v3 over "model" on a (data, model) grid of logical
    devices (MESH_ENCDEC), bf16, from weights held as shards (init per
    shard, each piece = the whole init's bit for bit): encode (each dp
    row's frames cut over its devices, every key visible), prefill with
    those states and a decode step, the counters reset just before and
    read just after (the path "model" both; flash sm90 one a layer a device
    of each row, encoder and decoder, no other kernel); against the same
    weights whole (whole_of) under the same ctx: the states, the prefill's
    and every step's logits of the same tokens within SHARD_TOL, greedy
    tokens equal up to a near-tie, and generate(ctx=) giving each model's
    own greedy tokens again; encode + prefill and decode-step ms of both
    in turns; peak GiB. -> (launches, flash routes, the line)."""
    import dataclasses as dc

    import repro_torch.kernels as kernels
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.models.model import (decode_step, encode, init_params,
                                          param_shapes, prefill)
    from repro_torch.serve.engine import generate
    from repro_torch.sharding.rules import make_ctx, param_shardings

    arch, L, _ = MESH_ENCDEC
    _, B, S = LM_ENCDEC_BATCH
    new = MESH_ENCDEC_NEW
    data, model = shape
    cfg = dc.replace(get_config(arch), n_layers=L, encoder_layers=L)
    grid = make_host_mesh(model, DEV)
    need(grid.shape == shape, f"grid {grid.shape}, want {shape}")
    ctx = make_ctx(grid)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sharded = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                          DEV, param_shardings(grid, param_shapes(cfg), cfg))
    init_matches(torch, cfg, sharded)
    params = whole_of(torch, sharded)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=DEV)
    frames = rng.standard_normal((B, cfg.encoder_ctx, cfg.d_model),
                                 dtype=np.float32)

    kernels.reset_launches()
    lm.reset_paths()
    enc = encode(sharded, frames, cfg, ctx)
    first, cache = prefill(sharded, {"tokens": x}, cfg, S + new, ctx,
                           enc=enc)
    decode_step(sharded, first[:, -1].argmax(-1, keepdim=True), cache, cfg,
                enc=enc, ctx=ctx)
    torch.cuda.synchronize()
    name = f"lm mesh whisper {data}x{model}"
    launches = {name: check_launches(name, kernels.launch_counts())}
    routes = dict(fa.flash_attention.route_launches)
    need(lm.path_counts == {"whole": 0, "rows": 0, "model": 2},
         f"{arch} {shape}: prefill and decode_step took the paths "
         f"{lm.path_counts}")
    need(routes == {"sm90": 2 * L * data * model, "cuda_core": 0},
         f"{arch} {shape}: encode and prefill launched the flash routes "
         f"{routes}")
    del first, cache

    enc_w = encode(params, frames, cfg, ctx)
    enc_rel = _rel_l2(torch, enc, enc_w)
    t_sh, l_sh = mesh_generate(torch, sharded, cfg, x, new, ctx, enc=enc)
    t_wh, l_wh = mesh_generate(torch, params, cfg, x, new, ctx, enc=enc_w)
    shard_rel = _rel_l2(torch, l_sh[:, 0], l_wh[:, 0])
    ok = torch.ones_like(t_sh, dtype=torch.bool)
    ok[:, 1:] = torch.cumprod((t_sh == t_wh).int(), 1)[:, :-1].bool()
    diff = l_sh - l_wh
    step_rel = float(diff.square().sum(-1)[ok].sum().sqrt()
                     / l_wh.square().sum(-1)[ok].sum().sqrt())
    need(max(enc_rel, shard_rel, step_rel) <= SHARD_TOL,
         f"{arch} {shape}: sharded vs whole relative L2: states {enc_rel}, "
         f"prefill logits {shard_rel}, steps {step_rel} > {SHARD_TOL}")
    tie = max(2 * float(diff.abs().amax(-1)[ok].max()), 2.0 ** -4)
    same = tokens_to_tie(torch, t_sh, t_wh, l_wh, tie)
    for p, t in ((sharded, t_sh), (params, t_wh)):
        got = generate(p, cfg, x, new, ctx=ctx, enc_input=frames)
        need(torch.equal(got[:, S:], t),
             f"{arch} {shape}: generate(ctx=) gave other tokens than "
             f"encode, prefill and decode_step")
    del l_sh, l_wh, diff

    def runs(p):
        def pre():
            e = encode(p, frames, cfg, ctx)
            return prefill(p, {"tokens": x}, cfg, S + new, ctx, enc=e), e
        return pre, lambda cache, e: decode_step(p, x[:, -1:], cache, cfg,
                                                 enc=e, ctx=ctx)
    ms = {"model": [], "whole": []}
    for _ in range(2):
        for k, p in (("model", sharded), ("whole", params)):
            pre, dec = runs(p)
            m_pre = host_ms(torch, pre, 1)
            (_, cache), e = pre()
            ms[k].append((m_pre, host_ms(torch, lambda: dec(cache, e), 4)))
    med = {k: [float(np.median(c)) for c in zip(*v)] for k, v in ms.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, sharded, enc, enc_w
    torch.cuda.empty_cache()
    line = (f"  mesh whisper {L}+{L}L {data}x{model} model: shards = whole: "
            f"init, states/prefill/steps {enc_rel:.0e}/{shard_rel:.0e}/"
            f"{step_rel:.0e}, tokens {same}, generate = own; sm90 "
            f"{routes['sm90']}; ms model/whole: encode+prefill "
            f"{med['model'][0]:.1f}/{med['whole'][0]:.1f}, decode "
            f"{med['model'][1]:.1f}/{med['whole'][1]:.1f}; {peak:.1f} GiB")
    return launches, routes, line


def mesh_windows(torch, np):
    """COPROC_WINDOWS windows (coproc_windows) placed over MESH_WINDOWS
    logical devices of the card (core/pipeline.py:shard_over_data, the
    batch over "data") through each COPROC_CONFIGS path, the launch
    counters reset just before and read just after: the scores and
    verdicts equal the one-device run's bit for bit. -> (launches,
    text)."""
    import repro_torch.api as api
    import repro_torch.core.pipeline as pipe
    import repro_torch.kernels as kernels
    from repro_torch.launch.mesh import make_host_mesh

    wins, svm_np = coproc_windows(np)
    svm = {k: torch.from_numpy(v).to(DEV) for k, v in svm_np.items()}
    x = torch.from_numpy(wins).to(DEV)
    os.environ["REPRO_TEST_DEVICES"] = str(MESH_WINDOWS)
    grid = make_host_mesh(1, DEV)
    placed = pipe.shard_over_data(grid, wins)
    launches, parts = {}, []
    for name in COPROC_CONFIGS:
        preset, path = WINDOW_CONFIGS[name]
        cfg = api.presets(preset).hog
        one = pipe.classify_windows(svm, x, cfg, path)
        kernels.reset_launches()
        got = pipe.classify_windows(svm, placed, cfg, path)
        torch.cuda.synchronize()
        key = "mesh windows " + name[7:]
        launches[key] = check_launches(key, kernels.launch_counts())
        need(torch.equal(got["score"], one["score"])
             and torch.equal(got["human"], one["human"]),
             f"{key}: {COPROC_WINDOWS} windows over {MESH_WINDOWS} devices "
             f"differ from one device's")
        ms = host_ms(torch, lambda: pipe.classify_windows(svm, placed, cfg,
                                                          path), 3)
        parts.append(f"{path} {ms:.2f} ms")
        n = max(launches[key].values())
    del x, placed
    return launches, (f"windows {COPROC_WINDOWS} over {MESH_WINDOWS} = 1 "
                      f"device: " + ", ".join(parts)
                      + f" ({n} launches a kernel)")


def mesh_train(torch, np, arch, layers, shape, batch_shape=TRAIN_BATCH,
               steps=TRAIN_STEPS):
    """The sharded (ZeRO-3) trainer over "model": ``arch`` at full width
    with ``layers`` layers (whisper: encoder and decoder layers each) on a
    (data, model) grid of logical devices, bf16, ``batch_shape`` (B 4 x S
    512) of lm_data (whisper's with its seeded frames), through
    jit_train_step's "model" path (context-parallel: each dp row's
    sequence cut over its devices, the flash forward and backward at each
    chunk's offset; whisper's encoder first, non-causal over each chunk
    of frames). Step 1's gradient
    (a MoE at capacity factor E / k: nothing drops), gathered from the
    shards, against make_train_step's (local MoE) leaf by leaf within
    TRAIN_GRAD_TOL; then ``steps`` steps at the config's own factor
    with the counters reset just before and read just after (the loss
    falls; the path counter; flash forward and backward launched on sm90
    once a chunk: the forward twice, with the recompute); ms a step
    beside the plain step's and the row path's on the same grid
    (``row_path``); per-device state bytes from
    state_shardings, and MESH_PLAN's, computed without allocating. ->
    (launches, forward routes, backward routes, stdout line)."""
    import dataclasses as dc

    import repro_torch.kernels as kernels
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.models import moe
    from repro_torch.models.model import loss_fn
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              jit_train_step,
                                              make_train_step, shard_state,
                                              state_device_bytes,
                                              state_shardings)

    cfg = dc.replace(get_config(arch), n_layers=layers)
    if cfg.encoder_layers:
        cfg = dc.replace(cfg, encoder_layers=layers)
    B, S = batch_shape
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator(device=DEV).manual_seed(0),
                             DEV)
    params = state["params"]
    grid = make_host_mesh(shape[1], DEV)
    need(grid.shape == shape, f"grid {grid.shape}, want {shape}")
    sh = state_shardings(grid, state, cfg)
    sharded = shard_state(state, sh)
    batch = train_batch(np, cfg, B, S)
    dev_batch = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)

    # step 1's gradient where nothing drops: sharded against plain
    ncfg = (dc.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            if cfg.is_moe else cfg)
    loss_p = loss_fn(params, dev_batch, ncfg)
    loss_p.backward()
    moe.reset_paths()
    lm.reset_paths()
    loss_s, acc = jit_train_step(ncfg, opt, grid).grads(sharded, batch)
    need(lm.path_counts["model"] == 1,
         f"the sharded gradient took the paths {lm.path_counts}")
    need(not cfg.is_moe or (moe.path_counts["local"] == 0
                            and moe.path_counts["a2a"] > 0),
         f"the sharded gradient's MoE took {moe.path_counts}")
    leaf = {}
    for name, p in params.named_parameters():
        g = sh["params"][name].gather([acc[name].get(i)
                                       for i in range(grid.size)])
        # a parameter no op reads (mamba2's ln2) takes no gradient: zero
        want = (p.grad.float() if p.grad is not None
                else torch.zeros_like(g))
        leaf[name] = float((g - want).norm()
                           / want.norm().clamp(min=1e-30))
        p.grad = None
    del acc
    worst = max(leaf, key=leaf.get)
    need(leaf[worst] <= TRAIN_GRAD_TOL,
         f"sharded vs plain gradient: {worst} relative L2 {leaf[worst]}")
    loss_p = float(loss_p.detach())
    dl = abs(float(loss_s) - loss_p)
    need(dl <= TRAIN_LOSS_TOL * loss_p,
         f"sharded vs plain loss {float(loss_s)} vs {loss_p}")

    step = jit_train_step(cfg, opt, grid)
    kernels.reset_launches()
    lm.reset_paths()
    losses = []
    for _ in range(steps):
        sharded, m = step(sharded, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    name = "lm mesh train"
    short = arch.split("-")[0]
    launches = {f"{name} {short}": check_launches(
        f"{name} {short}" if f"{name} {short}" in PATH_KERNELS else name,
        kernels.launch_counts())}
    paths = dict(lm.path_counts)
    fwd = dict(fa.flash_attention.route_launches)
    bwd = dict(fa.flash_attention_bwd.route_launches)
    chunks = (flash_layers(cfg) + cfg.encoder_layers) * shape[0] \
        * shape[1] * steps
    need(paths["model"] == steps and paths["rows"] == 0,
         f"the sharded steps took the paths {paths}")
    need(fwd == {"sm90": 2 * chunks, "cuda_core": 0}
         and bwd == {"sm90": chunks, "cuda_core": 0},
         f"the sharded steps launched flash {fwd} forward and {bwd} "
         f"backward")
    need(all(np.isfinite(losses)) and losses[-1] < losses[0],
         f"the sharded trainer's loss did not fall: {losses}")
    ms = host_ms(torch, lambda: step(sharded, batch), 2)
    with row_path():
        ms_rows = host_ms(torch, lambda: step(sharded, batch), 2)
    plain = make_train_step(cfg, opt)
    ms_plain = host_ms(torch, lambda: plain(state, dev_batch), 2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_dev = state_device_bytes(grid, cfg)
    plan_arch, plan_shape = MESH_PLAN
    plan = state_device_bytes(make_host_mesh(plan_shape[1], DEV),
                              get_config(plan_arch))
    level_line(f"  {name} {arch} {shape}: loss {losses}; leaf rel L2 "
               f"(worst {worst}) {sorted(leaf.values())[-5:]}; per-device "
               f"state bytes {per_dev}; {plan_arch} {plan_shape} {plan}; "
               f"ms a step model / rows / plain {ms:.1f} / {ms_rows:.1f} / "
               f"{ms_plain:.1f}; peak {peak:.1f} GiB")
    del state, params, sharded, step, plain, dev_batch
    torch.cuda.empty_cache()
    line = (f"  mesh train {arch.split('-')[0]} {layers}L {shape[0]}x"
            f"{shape[1]} model x{paths['model']}: grad {leaf[worst]:.1e} "
            f"(tol {TRAIN_GRAD_TOL:g}), loss {losses[0]:.2f}->"
            f"{losses[-1]:.2f}, sm90 {fwd['sm90']}/{bwd['sm90']}, "
            f"{ms:.0f} ms/step (rows {ms_rows:.0f}, plain {ms_plain:.0f}), "
            f"{max(per_dev) / 2 ** 30:.2f} GiB/device")
    return launches, fwd, bwd, line


def mesh_pipe(torch, np):
    """gpipe_apply: MESH_PIPE's full-width qwen3-14b layers in bf16 over a
    "pipe" grid of logical devices, M microbatches; its output and the
    parameters' gradients (of a seeded projection of the output) against
    the sequential run's within the bf16 limits (CONSIST_TOL,
    TRAIN_GRAD_TOL), flash sm90 forward and backward launched with the
    counters reset just before and read just after. -> (launches,
    forward routes, backward routes, text)."""
    import dataclasses as dc

    import repro_torch.kernels as kernels
    import repro_torch.kernels.flash_attention as fa
    import repro_torch.models.model as mm
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import grid_of, visible_devices
    from repro_torch.models.attention import arange_positions
    from repro_torch.train.pipeline import bubble_fraction, gpipe_apply

    layers, stages, M, Bm, S = MESH_PIPE
    cfg = dc.replace(get_config(LM_ARCH), n_layers=layers)
    params = mm.trainable(mm.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(0), DEV))
    os.environ["REPRO_TEST_DEVICES"] = str(stages)
    grid = grid_of(visible_devices(DEV), (stages,), ("pipe",))
    gen = torch.Generator(device=DEV).manual_seed(3)
    x = torch.randn((M, Bm, S, cfg.d_model), generator=gen, device=DEV
                    ).to(cfg.dtype)
    probe = torch.randn((Bm, S, cfg.d_model), generator=gen, device=DEV)

    def layer_fn(lp, h):
        return mm._layer_x(h, lp, cfg, arange_positions(Bm, S, h.device), 0,
                           None, True, None)

    def run(fn):
        out = fn()
        (out.float() * probe).sum().backward()
        g = {k: p.grad for k, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return out.detach(), g

    kernels.reset_launches()
    out_p, g_p = run(lambda: gpipe_apply(layer_fn, list(params.layers), x,
                                         grid))
    torch.cuda.synchronize()
    name = "lm mesh gpipe"
    launches = {name: check_launches(name, kernels.launch_counts())}
    fwd = dict(fa.flash_attention.route_launches)
    bwd = dict(fa.flash_attention_bwd.route_launches)
    need(fwd == {"sm90": layers * M, "cuda_core": 0}
         and bwd == {"sm90": layers * M, "cuda_core": 0},
         f"gpipe launched flash {fwd} forward and {bwd} backward")

    def sequential():
        outs = []
        for m in range(M):
            h = x[m]
            for lp in params.layers:
                h = layer_fn(lp, h)
            outs.append(h)
        return torch.stack(outs)

    out_s, g_s = run(sequential)
    rel_out = float((out_p.float() - out_s.float()).norm()
                    / out_s.float().norm())
    rel_g = max(float((g_p[k].float() - g_s[k].float()).norm()
                      / g_s[k].float().norm().clamp(min=1e-30))
                for k in g_s if g_s[k] is not None)
    need(rel_out <= CONSIST_TOL and rel_g <= TRAIN_GRAD_TOL,
         f"gpipe vs sequential: output {rel_out}, worst gradient {rel_g}")
    del params, g_p, g_s, x
    torch.cuda.empty_cache()
    text = (f"gpipe {LM_ARCH.split('-')[0]} {layers}L/{stages} M{M}: "
            f"{rel_out:.0e}/{rel_g:.0e} vs sequential, bubble "
            f"{bubble_fraction(M, stages):.3f}")
    return launches, fwd, bwd, text


def lm_mesh(torch, np):
    """Phase 5d: the LM meshes on logical devices of the card
    (REPRO_TEST_DEVICES set for the phase only): each MESH_SERVE cell
    served from weights held as shards (mesh_serve), windows over a grid
    (mesh_windows), the sharded trainer (mesh_train), whisper
    (MESH_ENCDEC) and mamba2 and hymba (MESH_SSM) served and trained over
    "model", and gpipe_apply (mesh_pipe). -> (launches, forward routes,
    backward routes)."""
    import repro_torch.kernels.flash_attention as fa

    saved = os.environ.get("REPRO_TEST_DEVICES")
    launches, fwd = {}, dict.fromkeys(fa.ROUTES, 0)
    bwd = dict.fromkeys(fa.ROUTES, 0)
    try:
        for arch, layers, shape, B, S, new in MESH_SERVE:
            os.environ["REPRO_TEST_DEVICES"] = str(shape[0] * shape[1])
            got, routes, line = mesh_serve(torch, np, arch, layers, shape,
                                           B, S, new)
            launches.update(got)
            fwd = {r: n + routes[r] for r, n in fwd.items()}
            print(line, flush=True)
        got, text = mesh_windows(torch, np)
        launches.update(got)
        for arch, layers, shape in MESH_TRAIN:
            os.environ["REPRO_TEST_DEVICES"] = str(shape[0] * shape[1])
            got, f, b, line = mesh_train(torch, np, arch, layers, shape)
            launches.update(got)
            fwd = {r: n + f[r] for r, n in fwd.items()}
            bwd = {r: n + b[r] for r, n in bwd.items()}
            print(line, flush=True)
        arch, layers, grids = MESH_ENCDEC
        for shape in grids:
            os.environ["REPRO_TEST_DEVICES"] = str(shape[0] * shape[1])
            got, routes, line = mesh_encdec(torch, np, shape)
            launches.update(got)
            fwd = {r: n + routes[r] for r, n in fwd.items()}
            got, f, b, line2 = mesh_train(
                torch, np, arch, layers, shape,
                (LM_ENCDEC_BATCH[1], LM_ENCDEC_BATCH[2]), MESH_ENCDEC_STEPS)
            launches.update({f"{k} {shape[0]}x{shape[1]}": v
                             for k, v in got.items()})
            fwd = {r: n + f[r] for r, n in fwd.items()}
            bwd = {r: n + b[r] for r, n in bwd.items()}
            print(f"{line}; train x{MESH_ENCDEC_STEPS}: "
                  + line2.split(": ", 1)[1], flush=True)
        for arch, layers, B, S in MESH_SSM:
            for shape in MESH_SSM_GRIDS:
                os.environ["REPRO_TEST_DEVICES"] = str(shape[0] * shape[1])
                Bg = max(B, shape[0])           # a row a dp row at least
                got, routes, line = mesh_serve(torch, np, arch, layers,
                                               shape, Bg, S, MESH_SSM_NEW)
                launches.update(got)
                fwd = {r: n + routes[r] for r, n in fwd.items()}
                got, f, b, line2 = mesh_train(torch, np, arch, layers, shape,
                                              (Bg, S), MESH_SSM_STEPS)
                launches.update({f"{k} {shape[0]}x{shape[1]}": v
                                 for k, v in got.items()})
                fwd = {r: n + f[r] for r, n in fwd.items()}
                bwd = {r: n + b[r] for r, n in bwd.items()}
                print(f"{line}; train x{MESH_SSM_STEPS}: "
                      + line2.split(": ", 1)[1], flush=True)
        got, f, b, text2 = mesh_pipe(torch, np)
    finally:
        if saved is None:
            os.environ.pop("REPRO_TEST_DEVICES", None)
        else:
            os.environ["REPRO_TEST_DEVICES"] = saved
    launches.update(got)
    fwd = {r: n + f[r] for r, n in fwd.items()}
    bwd = {r: n + b[r] for r, n in bwd.items()}
    print(" " + text2, flush=True)
    print("  mesh " + text, flush=True)
    return launches, fwd, bwd


# ------------------------------------------------------------ phase 5e

# the dry run's predictions of phase 5e's cells at one device (run in a
# process of its own beside the card's phases: it traces on the meta
# device, allocates nothing and never touches the card)
# the CPU's scores of the co-processor's windows come first, on 2 threads
_PREDICT = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[3])
import chip_smoke as cs
from repro_torch.launch.dryrun import one_device, production_grid, run_cell
out = {}


def write():
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)


torch.set_num_threads(2)
np.savez(sys.argv[2] + ".npz", **cs.coproc_cpu(np))
out["coproc_cpu"] = {"path": sys.argv[2] + ".npz"}
write()
torch.set_num_threads(1)
grid = one_device(production_grid(False))
for key, kw in json.loads(sys.argv[1]):
    try:
        r = run_cell(grid=grid, **kw)
        out[key] = {"peak": r["mem"]["peak_bytes"], "step": r["step_time_s"],
                    "bound": r["bottleneck"]}
    except Exception as e:
        out[key] = {"error": repr(e)}
    write()
"""


def shape_cells():
    """Phase 5e's cells of the reference's shape set: (arch, layers (None:
    all), profile, length, decode shape)."""
    from repro_torch.configs import (ARCH_IDS, SHAPE_BY_NAME, get_config,
                                     shape_applicable)
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for dec in ("decode_32k", "long_500k"):
            if shape_applicable(cfg, SHAPE_BY_NAME[dec])[0]:
                cells.append((arch, (LONG_LAYERS if dec == "long_500k"
                                     else SHAPE_LAYERS).get(arch),
                              SHAPE_PROFILE.get(arch, "baseline"),
                              SHAPE_BY_NAME[dec].seq_len, dec))
    return cells


def start_predictions():
    """Start the dry run of every phase 5e cell at one device and B 1 (the
    dense configs at B 4 x S 512) -> (process, path of its JSON)."""
    import tempfile
    jobs = [(f"{a} B4xS512", dict(arch=a, shape_name="prefill_32k",
                                  batch=4, seq_len=512)) for a in LM_DENSE]
    for arch, layers, prof, S, dec in shape_cells():
        kw = dict(arch=arch, batch=1, layers=layers or 0, profile=prof)
        jobs.append((f"{arch} {S} prefill",
                     dict(kw, shape_name="prefill_32k", seq_len=S)))
        jobs.append((f"{arch} {S} decode", dict(kw, shape_name=dec)))
    L, B, S, _ = TRAIN_4K
    jobs.append(("train_4k", dict(arch=LM_ARCH, shape_name="train_4k",
                                  batch=B, layers=L)))
    jobs.append(("hog_svm_coproc", dict(arch="hog_svm_coproc",
                                        shape_name="train_4k",
                                        batch=COPROC_WINDOWS)))
    # the longest traces last: phase 5e reads them last
    jobs.sort(key=lambda j: j[1].get("seq_len", 0) > 32768)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="dryrun_")
    os.close(fd)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", _PREDICT,
                             json.dumps(jobs), path, str(ROOT)], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, path


class Predictions:
    """The dry run's numbers of a phase 5e cell, read from the process
    start_predictions started (waited for where not yet written)."""

    def __init__(self, proc, path):
        self.proc, self.path = proc, path

    def _read(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def get(self, key: str) -> dict:
        t0 = time.perf_counter()
        while key not in (got := self._read()):
            need(self.proc.poll() is None and time.perf_counter() - t0 < 600,
                 f"the dry run wrote no prediction of {key}: "
                 f"{(self.proc.stderr.read() if self.proc.poll() is not None else 'timed out')[-800:]}")
            time.sleep(1)
        need("error" not in got[key], f"background job {key}: {got[key]}")
        return got[key]

    def text(self, key: str) -> str:
        p = self.get(key)
        return f"dry {p['peak'] / 2 ** 30:.2f} GiB {p['step'] * 1e3:.4g} ms"

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        for path in (self.path, self.path + ".npz"):
            with contextlib.suppress(OSError):
                os.remove(path)


def _busy(times) -> tuple:
    return (sum(t for _, t in times.values()) / 1e3,
            sum(c for c, _ in times.values()))


def last_gates(torch, fn, pin=None):
    """Run ``fn()`` recording each MoE layer's gates (f32 (E,)) of its last
    token, in call order -> (fn's result, [gates]). ``pin``: gates of an
    earlier run, whose top-k choice each layer's last token then takes
    (weighted by this run's own gates), where the two runs' choices
    differ."""
    import repro_torch.models.moe as moe

    top_k, calls = moe._top_k, []

    def recording(gates, k):
        w, idx = top_k(gates, k)
        calls.append(gates[-1].float().clone())
        if pin is not None:
            want = top_k(pin[len(calls) - 1][None], k)[1][0]
            idx = idx.clone()
            idx[-1] = want
            w = w.clone()
            w[-1] = gates[-1, want]
        return w, idx

    moe._top_k = recording
    try:
        return fn(), calls
    finally:
        moe._top_k = top_k


def routed(torch, fn, pin=None):
    """Run ``fn()`` recording every MoE routing's gates (f32 (T, E)), in
    call order -> (fn's result, [gates]). ``pin``: an earlier run's gates
    of the same calls, whose top-k choice every token then takes,
    weighted by this run's own gates (``routed_flips`` counts where the
    choices differed)."""
    import repro_torch.models.moe as moe

    top_k, calls = moe._top_k, []

    def recording(gates, k):
        w, idx = top_k(gates, k)
        calls.append(gates.float().clone())
        if pin is not None:
            idx = top_k(pin[len(calls) - 1].to(gates.device), k)[1]
            w = gates.gather(1, idx)
        return w, idx

    moe._top_k = recording
    try:
        return fn(), calls
    finally:
        moe._top_k = top_k


def routed_flips(torch, got, want, k: int) -> tuple:
    """Tokens whose top-k experts differ between two runs' gates
    (``routed``, call by call), and how many of them are near-ties: the
    second run's gap between its k-th and (k+1)-th gate within twice
    the token's largest gate difference -> (flips, near-ties). Each
    routing takes the top-k twice (models/moe.py:_shard_route: the
    dispatch, then the combine), so every second call is counted."""
    flips = ties = 0
    for g, w in zip(got[::2], want[::2]):
        w = w.to(g.device)
        ig = torch.sort(g, dim=-1, descending=True, stable=True)[1][:, :k]
        sw, iw = torch.sort(w, dim=-1, descending=True, stable=True)
        differ = (ig.sort(-1)[0] != iw[:, :k].sort(-1)[0]).any(-1)
        near = (sw[:, k - 1] - sw[:, k]) <= 2 * (g - w).abs().amax(-1)
        flips += int(differ.sum())
        ties += int((differ & near).sum())
    return flips, ties


def route_flips(torch, got, want, k: int) -> tuple:
    """Layers whose last token's top-k experts differ between two runs'
    gates (last_gates), and whether each is a near-tie: the first run's
    gap between its k-th and (k+1)-th gate within twice the largest gate
    difference between the runs in that layer -> (flips, near-ties)."""
    flips = ties = 0
    for g, w in zip(got, want):
        sg, ig = torch.sort(g, descending=True, stable=True)
        sw, iw = torch.sort(w, descending=True, stable=True)
        if set(ig[:k].tolist()) != set(iw[:k].tolist()):
            flips += 1
            ties += float(sw[k - 1] - sw[k]) <= 2 * float((g - w).abs().max())
    return flips, ties


def length_cell(torch, np, arch, layers, profile, S, dec, pred) -> tuple:
    """One arch at one of the reference's lengths, B 1: prefill S (host
    ms; flash launches by route, every other kernel 0), prefill S - 1
    under the profiler (busy ms, launches) and one decode_step against
    the S-row cache (host and busy ms), its logits held to the first
    prefill's last within CONSIST_TOL; the peak beside the dry run's.
    A MoE's last token may take other experts in the decode than in the
    prefill where two gates nearly tie (bf16 rounding moves them): then
    every such flip must be a near-tie (route_flips) and the decode with
    the prefill's choices (last_gates' pin) must pass. -> (the line, the
    cell's launch counts, the failure or "")."""
    import dataclasses as dc

    import repro_torch.kernels as kernels
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import (decode_step, encode, init_params,
                                          prefill)
    from repro_torch.sharding.rules import PROFILES, make_ctx

    cfg = get_config(arch)
    if layers:
        cfg = dc.replace(cfg, n_layers=layers)
    ctx = make_ctx(make_host_mesh(1, DEV), profile=PROFILES[profile]) \
        if profile != "baseline" else None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)), device=DEV)
    full, part = {"tokens": x}, {"tokens": x[:, :-1]}
    if cfg.mrope:   # text positions on the host: the flash route
        pos = np.broadcast_to(np.arange(S)[None, :, None], (1, S, 3))
        full["positions"], part["positions"] = pos, pos[:, :-1]
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = encode(params, rng.standard_normal(
        (1, cfg.encoder_ctx, cfg.d_model), dtype=np.float32), cfg) \
        if cfg.encoder_layers else None
    first, calls = moe_drops(
        torch, lambda: prefill(params, full, cfg, S, ctx=ctx, enc=enc)[0])
    a = first[:, -1].float()
    torch.cuda.synchronize()
    ms_pre = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    routes = dict(fa.flash_attention.route_launches)
    per = flash_layers(cfg) + cfg.encoder_layers
    need(routes == {"sm90": per, "cuda_core": 0}
         and all(n == (per if k == "flash_attention" else 0)
                 for k, n in counts.items()),
         f"{arch} S{S}: launches {counts}, flash {routes}, want sm90 {per} "
         f"and no other kernel")
    del first
    note = ""
    if cfg.is_moe:
        if any(bool(c.any()) for c in calls):
            # an overflowing expert drops the latest tokens first, and the
            # capacity follows the token count: prefill S and S - 1 drop
            # other choices, so the consistency runs at capacity factor
            # E / k, where nothing drops (as the lm families phase checks)
            ccfg = dc.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            note = (f"; cf {cfg.capacity_factor:g} drops "
                    f"{sum(int(c.sum()) for c in calls)}, checked at cf "
                    f"{ccfg.capacity_factor:g}")
            cfg = ccfg
        out, gates = last_gates(torch, lambda: prefill(
            params, full, cfg, S, ctx=ctx, enc=enc)[0])
        a = out[:, -1].float()
    holder = {}

    def run_part():
        holder["c"] = prefill(params, part, cfg, S, ctx=ctx, enc=enc)[1]

    busy, n_pre = _busy(device_times(torch, run_part, 1, warm=False))
    cache = holder.pop("c")
    i0 = cache["idx"]
    kept = {t: cache[t][:, :, i0:i0 + 1].clone() if t in ("k", "v")
            else cache[t].clone()
            for t in ("k", "v", "state", "conv") if t in cache}

    def run_decode():
        out = decode_step(params, x[:, -1:], cache, cfg, enc=enc, ctx=ctx)
        with torch.inference_mode():      # the step writes its row in place
            for t, v in kept.items():
                (cache[t][:, :, i0:i0 + 1] if t in ("k", "v")
                 else cache[t]).copy_(v)
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = run_decode()[0][:, -1].float()
    torch.cuda.synchronize()
    ms_dec = (time.perf_counter() - t0) * 1e3
    dbusy, n_dec = _busy(device_times(torch, run_decode, 1))
    rel = float((a - b).norm() / a.norm())
    fail = "" if bool(torch.isfinite(a).all()) and rel <= CONSIST_TOL \
        else f"rel L2 {rel} > {CONSIST_TOL}"
    if cfg.is_moe:
        b, dgates = last_gates(torch, run_decode)
        flips, ties = route_flips(torch, dgates, gates, cfg.top_k)
        if flips:
            pinned = last_gates(torch, run_decode, pin=gates)[0]
            rel_pin = float((a - pinned[0][:, -1].float()).norm() / a.norm())
            note += (f"; last token's experts differ in {flips} layers "
                     f"({ties} near-ties), pinned {rel_pin:.1e}")
            if ties == flips and rel_pin <= CONSIST_TOL:
                fail = ""
            elif not fail:
                fail = f"{flips - ties} route flips are not near-ties"
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, cache, kept, enc
    torch.cuda.empty_cache()
    depth = f" {layers}L" if layers else ""
    prof = f" {profile}" if profile != "baseline" else ""
    pp, pd = pred.get(f"{arch} {S} prefill"), pred.get(f"{arch} {S} decode")
    line = (f"  {arch.split('-')[0]}{depth}{prof} S{S}: pre {ms_pre:.1f} ms "
            f"({pp['step'] * 1e3:.4g}) busy {busy:.1f}, {n_pre} l, sm90 "
            f"{per}; dec {ms_dec:.2f} ({pd['step'] * 1e3:.3g}) busy "
            f"{dbusy:.2f}, {n_dec} l; rel {rel:.1e}{note}; {peak:.2f} GiB "
            f"({pp['peak'] / 2 ** 30:.2f}/{pd['peak'] / 2 ** 30:.2f})")
    return line, counts, fail and f"{arch} S{S}: prefill vs prefill[:-1] " \
        f"+ decode_step {fail}"


def train_4k(torch, np, pred) -> tuple:
    """qwen3-14b at TRAIN_4K's layers, B 1 x S 4,096 (train_4k's length):
    the gradient with the kernels against the plain flash forward and
    backward (worst leaf within TRAIN_GRAD_TOL), then AdamW steps with the
    counters reset just before and read just after (loss finite and
    falling). -> (the line, launches, forward routes, backward routes)."""
    import dataclasses as dc

    import repro_torch.kernels as kernels
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import loss_fn
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    L, B, S, steps = TRAIN_4K
    cfg = dc.replace(get_config(LM_ARCH), n_layers=L)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator(device=DEV).manual_seed(0),
                             DEV)
    params = state["params"]
    batch = {k: torch.as_tensor(v, device=DEV)
             for k, v in train_batch(np, cfg, B, S).items()}

    def grads_once():
        loss = loss_fn(params, batch, cfg)
        loss.backward()
        g = {k: p.grad for k, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return float(loss.detach()), g

    loss_k, g_k = grads_once()
    with plain_flash(fa):
        loss_p, g_p = grads_once()
    leaf = {k: float((g_k[k].float() - g_p[k].float()).norm()
                     / g_p[k].float().norm())
            for k in g_k if float(g_p[k].float().norm()) > 0}
    worst = max(leaf, key=leaf.get)
    need(leaf[worst] <= TRAIN_GRAD_TOL
         and abs(loss_k - loss_p) <= TRAIN_LOSS_TOL * abs(loss_p),
         f"train_4k gradient kernels vs plain: {leaf[worst]} at {worst}, "
         f"loss {loss_k} vs {loss_p}")
    del g_k, g_p
    step = make_train_step(cfg, OptConfig(lr=TRAIN_LR, warmup_steps=1,
                                          total_steps=steps))
    kernels.reset_launches()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    ms = (time.perf_counter() - t0) * 1e3 / steps
    name = "lm shapes train_4k"
    launches = check_launches(name, kernels.launch_counts())
    routes = dict(fa.flash_attention.route_launches)
    bwd = dict(fa.flash_attention_bwd.route_launches)
    need(routes == {"sm90": 2 * L * steps, "cuda_core": 0}
         and bwd == {"sm90": L * steps, "cuda_core": 0},
         f"train_4k launched flash {routes} forward and {bwd} backward")
    need(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
         f"train_4k losses {losses}: not finite and falling")
    busy, n = _busy(device_times(torch, lambda: step(state, batch), 1))
    plan = fa.bwd_plan_sm90(B, cfg.n_heads, cfg.n_kv_heads, S, True,
                            build.sm_count(torch.cuda.current_device()))
    level_line(f"  train_4k bwd_plan_sm90 at B{B}xS{S}: {plan}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, params, batch, step
    torch.cuda.empty_cache()
    line = (f"  train_4k {LM_ARCH} {L}L B{B}xS{S}: grad vs plain worst leaf "
            f"{leaf[worst]:.1e} ({worst}; tol {TRAIN_GRAD_TOL:g}); loss "
            + " ".join(f"{v:.3f}" for v in losses) + f"; {ms:.1f} ms/step "
            f"({pred.text('train_4k')}; busy {busy:.1f}, {n} launches, sm90 "
            f"{2 * L}+{L} bwd); peak {peak:.2f} GiB")
    return line, launches, routes, bwd


def coproc_windows(np):
    """COPROC_WINDOWS seeded windows: Table I's split drawn with seeded
    shifts of up to 2 pixels, and the golden SVM as numpy."""
    import repro_torch.data.synth_pedestrian as synth

    g = np.load(ROOT / "tests" / "golden" / "hog_golden.npz")
    svm_np = {"w": g["svm_w"], "b": np.asarray(g["svm_b"], np.float32)}
    split, _ = synth.make_windows(160, 134, synth.PedestrianDataConfig(),
                                  np.random.default_rng(0))
    rng = np.random.default_rng(4)
    wins = split[rng.integers(0, len(split), COPROC_WINDOWS)]
    shift = rng.integers(-2, 3, (COPROC_WINDOWS, 2))
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            sel = (shift[:, 0] == dy) & (shift[:, 1] == dx)
            wins[sel] = np.roll(wins[sel], (dy, dx), axis=(1, 2))
    return wins, svm_np


def coproc_cpu(np) -> dict:
    """The CPU's scores and verdicts of coproc_windows for each of
    COPROC_CONFIGS (computed beside the card's phases, in the dry run's
    process)."""
    import repro_torch.api as api
    import repro_torch.core.pipeline as pipe

    wins, svm_np = coproc_windows(np)
    out = {}
    for name in COPROC_CONFIGS:
        preset, path = WINDOW_CONFIGS[name]
        ref = pipe.classify_windows(svm_np, wins, api.presets(preset).hog,
                                    path, device="cpu")
        out[f"{name} score"] = ref["score"].numpy()
        out[f"{name} human"] = ref["human"].numpy()
    return out


def coproc(torch, np, pred) -> tuple:
    """hog_svm_coproc: classify_windows on COPROC_WINDOWS seeded windows
    (coproc_windows) through the kernel and fused backends, counters reset
    just before each and read just after, scores held to the CPU's
    (coproc_cpu) as phase 4b holds them. -> (line, launches)."""
    import repro_torch.api as api
    import repro_torch.core.pipeline as pipe
    import repro_torch.kernels as kernels

    wins, svm_np = coproc_windows(np)
    svm = {k: torch.from_numpy(v).to(DEV) for k, v in svm_np.items()}
    x = torch.from_numpy(wins).to(DEV)
    launches, parts = {}, []
    for name in COPROC_CONFIGS:
        preset, path = WINDOW_CONFIGS[name]
        cfg = api.presets(preset).hog
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pipe.classify_windows(svm, x, cfg, path)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        key = "coproc " + name[7:]
        launches[key] = check_launches(key, kernels.launch_counts())
        busy, n = _busy(device_times(
            torch, lambda: pipe.classify_windows(svm, x, cfg, path), 1))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with np.load(pred.get("coproc_cpu")["path"]) as f:
            ref = {k: torch.from_numpy(f[f"{name} {k}"])
                   for k in ("score", "human")}
        tol = WINDOW_SCORE_TOL[preset]
        score = got["score"].cpu()
        need(score.shape == (COPROC_WINDOWS,)
             and bool(torch.isfinite(score).all()), f"{key}: scores")
        de = float((score - ref["score"]).abs().max())
        sure = ref["score"].abs() > tol
        need(de <= tol and torch.equal(got["human"].cpu()[sure],
                                       ref["human"][sure]),
             f"{key}: {COPROC_WINDOWS} windows, score delta {de} > {tol} or "
             f"human differs from the CPU where |score| > {tol}")
        parts.append(f"{name[7:]} {ms:.2f} ms (busy {busy:.2f}, {n} "
                     f"launches) delta {de:.1e} ({tol:g}), "
                     f"{int(got['human'].sum())} humans, peak {peak:.2f} GiB")
    line = (f"  hog_svm_coproc {COPROC_WINDOWS} windows ("
            f"{pred.text('hog_svm_coproc')}, path ref): " + "; ".join(parts))
    return line, launches


def lm_shapes(torch, np, pred):
    """Phase 5e: (a) LM_DENSE at full width with the lm families checks;
    (b) every arch at the reference's lengths at B 1 (length_cell), the
    train_4k cell (train_4k) and the co-processor's pod batch (coproc);
    each line with its measured peak beside the dry run's prediction.
    -> (launches by path, forward routes, backward routes)."""
    import repro_torch.kernels as kernels
    import repro_torch.kernels.flash_attention as fa

    launches, fwd = {}, dict.fromkeys(fa.ROUTES, 0)
    for arch in LM_DENSE:
        # on standard error since the lm mesh phase's qwen3 cells (the
        # standard output's 20 KB)
        got, sm90 = full_width(torch, np, arch, LM_BATCHES[:1],
                               LM_DENSE_F32_LAYERS.get(arch),
                               " (" + pred.text(f"{arch} B4xS512") + ")",
                               out=level_line)
        launches[f"lm {arch}"] = got
        fwd["sm90"] += sm90
    total = dict.fromkeys(kernels.launch_counts(), 0)
    failed, cells = [], []
    # each cell's line on standard error (the standard output's 20 KB), a
    # summary on standard output
    level_line(f"  the reference's lengths, B 1: prefill S (the dry run's "
               f"roofline ms), busy ms, launches, flash sm90; decode at S; "
               f"rel L2 of its logits to the prefill's last (tol "
               f"{CONSIST_TOL:g}); peak GiB (dry run: prefill/decode)")
    for cell in shape_cells():
        t0 = time.perf_counter()
        line, counts, fail = length_cell(torch, np, *cell, pred)
        level_line(f"time of {cell[0]} S{cell[3]}: "
                   f"{time.perf_counter() - t0:.1f} s")
        total = {k: n + counts[k] for k, n in total.items()}
        fwd["sm90"] += counts["flash_attention"]
        level_line(line)
        cells.append(f"{cell[0].split('-')[0]} S{cell[3]}")
        failed += [fail] if fail else []
    need(not failed, "; ".join(failed))
    print(f"  the reference's lengths, B 1: {len(cells)} cells (" +
          ", ".join(cells) + f"), prefill S against S - 1 + decode_step "
          f"within {CONSIST_TOL:g}, flash sm90 {total['flash_attention']}; "
          f"each cell's ms, busy ms, launches and peak beside the dry "
          f"run's on standard error", flush=True)
    launches["lm shapes"] = check_launches("lm shapes", total)
    line, got, f, bwd = train_4k(torch, np, pred)
    launches["lm shapes train_4k"] = got
    fwd = {r: n + f[r] for r, n in fwd.items()}
    print(line, flush=True)
    line, got = coproc(torch, np, pred)
    launches.update(got)
    print(line, flush=True)
    return launches, fwd, bwd


def _faults(rel, digits: int = 2) -> str:
    return ", ".join(f"{k} {v:.{digits}e}" for k, v in rel.items()
                     if k != "sound")


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
    """The tensor-core flash kernels (flash_attention_sm90, the forward;
    flash_attention_bwd_sm90, the backward) must run on the tensor cores
    through TMA with no spills: count HGMMA and UTMALDG in each library's
    SASS (cuobjdump) and read ptxas's spill lines; print both, fail on a
    zero or a spill."""
    cuobjdump = pathlib.Path(build.nvcc()).parent / "cuobjdump"
    text = []
    for name in ("flash_attention_sm90", "flash_attention_bwd_sm90"):
        lib = build.library_path(name)
        lines = lib.with_suffix(".log").read_text().splitlines()
        spills = [ln.strip() for ln in lines if "spill" in ln]
        need(bool(spills) and all(
            "0 bytes spill stores, 0 bytes spill loads" in ln
            for ln in spills), f"{name} spills: {spills}")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=120)
        need(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-500:]}")
        counts = {op: sass.stdout.count(op) for op in ("HGMMA", "UTMALDG")}
        need(all(counts.values()), f"{name} SASS: {counts}")
        text.append(f"{name} HGMMA {counts['HGMMA']} UTMALDG "
                    f"{counts['UTMALDG']} ({len(spills)} functions)")
    level_line("SASS: " + ", ".join(text) + "; no spills; setmaxnreg 240 / 24",
          flush=True)


def _r(x):
    return float(f"{x:.4g}") if isinstance(x, float) else x


def compact_mode(v: dict) -> dict:
    """A non-main mode's entry for the kernels line: its error ("err") and
    code flips ("flips"), to 4 significant digits (its device, plain,
    bound and library ms are on its check line)."""
    short = {"max_abs_err": "err", "code_flips": "flips"}
    return {short.get(k, k): _r(d) for k, d in v.items()
            if not isinstance(d, dict)}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("flash", "lm_shapes", "lm_mesh"),
                    help="build the kernels and run this phase alone; no "
                         "kernels or ok line (a check of one phase)")
    only = ap.parse_args(argv).only
    # every run probes the batch schedule: no autotune decision is read
    # from, or written to, a cache file
    os.environ["REPRO_AUTOTUNE_CACHE"] = ""
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: FAIL: src/repro_torch not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    pred = Predictions(*start_predictions())
    clock = [time.perf_counter()]

    def header(name: str) -> None:
        """A phase's header on standard output; the seconds since the
        last one on standard error."""
        now = time.perf_counter()
        level_line(f"time before {name}: {now - clock[0]:.1f} s")
        clock[0] = now
        print(f"{name}:", flush=True)

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
        level_line("ptxas registers, fewest-most over instantiations: "
                   + ", ".join(reports) + "; spill stores/loads, bytes: "
                   + (spills if any(map(sum, pair.values()))
                      else "0/0 in " + ", ".join(pair)))
        need(not any("spill" in r for r in reports)
             and not any(sum(v) for v in pair.values()), "ptxas spilled")
        sm90_report(build)
        if only:
            header(only.replace("_", " "))
            if only == "lm_mesh":
                lm_mesh(torch, np)
            elif only == "flash":
                check_flash(torch, np)
            else:
                lm_shapes(torch, np, pred)
            level_line(f"time of {only.replace('_', ' ')}: "
                       f"{time.perf_counter() - clock[0]:.1f} s")
            print(f"--only {only}: passed; no kernels or ok line")
            return 0

        one = torch.zeros(1, device=DEV)
        floor = kernel_device_ms(torch, lambda: one.add_(1), "")
        print("kernel checks vs plain (err: worst shape), per frame or "
              "window batch: device/plain/bound/library ms; launch floor "
              f"(1-element add_): {_fmt(floor)}", flush=True)
        summary = check_kernels(torch, np)
        check_batched_kernels(torch, np)
        summary.update(check_window_kernels(torch, np))
        print("  ptxas, SASS, level, plan, profile and detail lines: on standard "
              "error",
              flush=True)
        summary.update(check_flash(torch, np))
        header("main path")
        launches, configs, svm = main_path(torch, np)
        header("batch path")
        launches.update(batch_path(torch, np, configs, svm))
        launches.update(stream_path(torch, np, configs, svm))
        launches.update(multihead_path(torch, np, configs, svm))
        header("window path")
        launches.update(window_path(torch, np))
        header("train path")
        launches.update(train_path(torch, np))
        header("serve path")
        launches.update(serve_path(torch, np, configs, svm))
        header("cascade path")
        launches.update(cascade_path(torch, np, svm))
        header("tiled path")
        launches.update(tiled_path(torch, np, svm, summary))
        header("LM path")
        lm_launches, flash_routes = lm_path(torch, np)
        launches.update(lm_launches)
        header("lm families")
        for fn in (lm_families, lm_encdec_vlm):
            family_launches, family_routes = fn(torch, np)
            launches.update(family_launches)
            flash_routes = {r: n + family_routes[r]
                            for r, n in flash_routes.items()}
        header("lm train")
        train_launches, train_routes, bwd_routes, bwd = lm_train(torch, np)
        launches.update(train_launches)
        flash_routes = {r: n + train_routes[r]
                        for r, n in flash_routes.items()}
        summary.update(bwd)
        header("lm mesh")
        mesh_launches, mesh_fwd, mesh_bwd = lm_mesh(torch, np)
        launches.update(mesh_launches)
        flash_routes = {r: n + mesh_fwd[r] for r, n in flash_routes.items()}
        bwd_routes = {r: n + mesh_bwd[r] for r, n in bwd_routes.items()}
        header("lm shapes")
        shape_launches, shape_fwd, shape_bwd = lm_shapes(torch, np, pred)
        launches.update(shape_launches)
        flash_routes = {r: n + shape_fwd[r] for r, n in flash_routes.items()}
        bwd_routes = {r: n + shape_bwd[r] for r, n in bwd_routes.items()}
        level_line(f"time of lm shapes: {time.perf_counter() - clock[0]:.1f} s")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    finally:
        pred.close()

    # launches: the sum of each path's own count (each read right after
    # that path's run), with the per-path counts beside it; the top-level
    # numbers are the main mode's sums at the main group (640x480 for the
    # dense kernels, B = 512 for the window kernels, B 4 x S 512 for
    # flash_attention), to 4 digits; every other mode's error and ms at the
    # main group are under "modes" (the main group's device, plain, bound
    # and library ms are on the kernel-check lines above, the other
    # groups' device us on the level and plan lines)
    kernels_line = {"kernels": []}
    for k in KERNELS:
        main = summary[k][MAIN_MODE[k]][MAIN_GROUP[k]]
        kernels_line["kernels"].append({
            "name": k, "route": "cuda", "source": KERNELS[k][0],
            "replaces": KERNELS[k][1],
            "launches": sum(c[k] for c in launches.values()),
            "max_abs_err": _r(summary[k]["max_abs_err"]),
            **{key: _r(main[key]) for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
            # the other modes' err (and flips) and ms; the main mode's
            # err is on its check line
            "modes": {m: compact_mode(v)
                      for m, v in summary[k].items()
                      if m not in ("max_abs_err", MAIN_MODE[k])},
            })
    flash = next(e for e in kernels_line["kernels"]
                 if e["name"] == "flash_attention")
    flash["launches_by_route"] = flash_routes
    # the query-offset form (one device's chunk of a context-parallel
    # prefill): its worst error by route, and at hd 128 device / plain /
    # SDPA-with-mask / bound ms at the first and last offsets
    chunk = summary["flash_attention_chunk"]
    flash["q_offset"] = {
        "shape": "B%dxH%dxK%dxSq%d of Sk%d" % FLASH_CHUNK,
        "max_abs_err": {k: _r(v) for k, v in chunk["max_abs_err"].items()},
        "ms_plain_sdpa_bound": {k: [_r(x) for x in v]
                                for k, v in chunk["ms"].items()}}
    # by path on standard error (the lm paths: about 750 bytes)
    level_line("flash_attention launches by path: " + json.dumps(
        {n: c["flash_attention"] for n, c in launches.items()
         if n.startswith("lm ")}, separators=(",", ":")))
    for m, v in flash["modes"].items():
        v["source"] = FLASH_SOURCES[m]
    # the backward's routes likewise: sm90 at the top level, cuda_core (in
    # bf16, timed beside it) and f32 under "modes"; its launches by route
    # on the train path
    bwd_entry = next(e for e in kernels_line["kernels"]
                     if e["name"] == "flash_attention_bwd")
    bwd_entry["launches_by_route"] = bwd_routes
    for m, v in bwd_entry["modes"].items():
        v["source"] = BWD_SOURCES[m]
    # its query-offset form likewise (rel L2 against the plain backward
    # by route, and at the first and last offsets span / plain /
    # SDPA-bwd / bound ms; the chunks summed against the whole sequence's
    # are on the phase 3c line on standard error)
    chunk = summary["flash_attention_bwd_chunk"]
    bwd_entry["q_offset"] = {
        "shape": "B%dxH%dxK%dxSq%d of Sk%d hd128" % FLASH_CHUNK,
        "rel_l2": {k: _r(v) for k, v in chunk["max_abs_err"].items()},
        "ms_plain_sdpa_bound": {k: [_r(x) for x in v]
                                for k, v in chunk["ms"].items()}}
    # the non-causal chunk (one device's frames of an encoder layer over
    # "model"), both directions: error against plain by route (the chunks
    # against the whole call on the phase 3c line) and at the first chunk
    # device / plain / SDPA / bound ms
    chunk = summary["flash_attention_enc_chunk"]
    shape = "B%dxH%dxK%dxSq%d of Sk%d hd%d" % FLASH_ENC_CHUNK
    for entry, i, key in ((flash, 0, "max_abs_err"), (bwd_entry, 1,
                                                      "rel_l2")):
        entry["noncausal"] = {
            "shape": shape,
            key: {m: _r(v[i]) for m, v in chunk["max_abs_err"].items()},
            "ms_plain_sdpa_bound": {m: [_r(x) for x in v[4 * i:4 * i + 4]]
                                    for m, v in chunk["ms"].items()}}
    # hymba's chunk (its global layers over a (1, 4) row, causal at
    # offsets off the tile grid), sm90 in bf16, both directions: error
    # against plain, then the chunks against the whole call
    chunk = summary["flash_attention_hymba_chunk"]
    shape = "B%dxH%dxK%dxSq%d of Sk%d hd%d" % FLASH_HYMBA_CHUNK
    for entry, i, key in ((flash, 0, "max_abs_err"), (bwd_entry, 1,
                                                      "rel_l2")):
        entry["hymba_chunk"] = {"shape": shape,
                                key: _r(chunk["max_abs_err"][i]),
                                "whole": _r(chunk["whole"][i])}
    print(json.dumps(kernels_line, separators=(",", ":")))
    print(card[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
