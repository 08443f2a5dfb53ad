#!/usr/bin/env python3
"""The flash-attention backward's time on both of its routes, and the
library's (the backward of ``scaled_dot_product_attention(enable_gqa=
True)``), read by two clocks in one process on one GPU, to tell the
card's clocks and the profiler's state apart:

    python3 tools/flash_bwd_time.py

Cases, in the (B, S, H, hd) layout that training hands the kernels:
qwen3-14b's (H 40, K 8, hd 128, causal) at B 4 x S 512 and B 1 x S
2,048 in bf16 on the sm90 route (csrc/flash_attention_bwd_sm90.cu) and
the cuda_core route (csrc/flash_attention_bwd.cu), in f32 (cuda_core)
at B 4 x S 512, and SDPA; hymba's global layers (B 1 x S 2,176, H 25, K
5, hd 64, causal) and whisper's encoder (B 4 x S 1,500, H = K = 20, hd
64, every key visible) on sm90 and SDPA. For each it prints
chip_smoke.py's ``timing_probe`` line (CUDA events over back-to-back
calls; torch.profiler's device time summed over the launches it
recorded; the card's clocks before and after) and ``kernel_span_ms``
(the span in which the case's kernels run: the sm90 route runs its dK/dV
and dQ kernels side by side on two streams, so their sum overstates it)
three times: cold, after WARM_S seconds of bf16 GEMMs, and after
SESSIONS short torch.profiler sessions. Then the card's name and power
limit. About 1.5 minutes on an H100.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
# name, B, H, K, S, hd, causal, (dtype, route) cases
SHAPES = (("qwen3 B4xS512", 4, 40, 8, 512, 128, True,
           (("bf16", "sm90"), ("bf16", "cuda_core"), ("f32", "cuda_core"))),
          ("qwen3 B1xS2048", 1, 40, 8, 2048, 128, True,
           (("bf16", "sm90"), ("bf16", "cuda_core"))),
          ("hymba", 1, 25, 5, 2176, 64, True, (("bf16", "sm90"),)),
          ("whisper-enc", 4, 20, 20, 1500, 64, False, (("bf16", "sm90"),)))
WARM_S = 20.0
SESSIONS = 300


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    import repro_torch.kernels.build as build
    import repro_torch.kernels.flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bwd_time: no CUDA device", file=sys.stderr)
        return 2
    build.build_all(["flash_attention", "flash_attention_sm90",
                     "flash_attention_bwd", "flash_attention_bwd_sm90"])
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    launch = {"sm90": fa.launch_bwd_sm90, "cuda_core": fa.launch_bwd_cuda_core}
    rng = np.random.default_rng(29)
    cases = []          # (label, fn, symbol, kernels a call or None)
    for where, B, H, K, S, hd, causal, runs in SHAPES:
        arrs = [torch.from_numpy(rng.standard_normal(
            (B, S, n, hd), dtype=np.float32)).cuda() for n in (H, K, K, H)]
        for dt in dict.fromkeys(d for d, _ in runs):
            q, k, v, do = (x.to(dts[dt]).transpose(1, 2) for x in arrs)
            out, lse = fa.flash_attention(q, k, v, causal, lse=True)
            for d, r in runs:
                if d != dt:
                    continue
                groups = fa.bwd_plan_sm90(B, H, K, S, causal,
                                          build.sm_count(0))["groups"]
                cases.append((
                    f"{where} {dt} {r}",
                    lambda q=q, k=k, v=v, out=out, do=do, lse=lse,
                    c=causal, fn=launch[r]: fn(q, k, v, out, do, lse, c),
                    "flash_attention_bwd",
                    3 + (r == "sm90" and groups > 1)))
            ql, kl, vl = (x.detach().contiguous().requires_grad_(True)
                          for x in (q, k, v))
            out_l = F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=causal, enable_gqa=True)
            cases.append((
                f"{where} {dt} SDPA",
                lambda o=out_l, x=(ql, kl, vl), do=do:
                torch.autograd.grad(o, x, do, retain_graph=True), "", None))

    def probe(when: str) -> None:
        for label, fn, symbol, per_call in cases:
            span = cs.kernel_span_ms(torch, fn, symbol)
            print(f"{when} {label}: span "
                  + ("not measured" if span is None else f"{span:.4g} ms")
                  + "; " + cs.timing_probe(torch, fn, symbol, per_call),
                  flush=True)

    probe("cold")
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_S:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()
    probe(f"after {WARM_S:g} s of GEMMs")
    one = torch.zeros(1, device="cuda")
    for _ in range(SESSIONS):
        cs.device_times(torch, lambda: one.add_(1), 5)
    probe(f"after {SESSIONS} profiler sessions")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
