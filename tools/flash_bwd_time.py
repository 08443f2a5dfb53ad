#!/usr/bin/env python3
"""The flash-attention backward kernel's time, and the library's
(the backward of ``scaled_dot_product_attention(enable_gqa=True)``),
read by two clocks in one process on one GPU, to tell the card's clocks
and the profiler's state apart:

    python3 tools/flash_bwd_time.py

Cases, in the (B, S, H, hd) layout that training hands the kernel:
qwen3-14b's (B 4, S 512, H 40, K 8, hd 128, causal) in bf16 and f32,
the kernel and SDPA; whisper's encoder (B 4, S 1,500, H = K = 20, hd
64, every key visible) in bf16, the kernel and SDPA. For each it prints
chip_smoke.py's ``timing_probe`` line (CUDA events over back-to-back
calls; torch.profiler's device time with the launches it recorded; the
card's clocks before and after) three times: cold, after WARM_S seconds
of bf16 GEMMs, and after SESSIONS short torch.profiler sessions. Then
the card's name and power limit.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
# name, B, H, K, S, hd, causal, dtypes
SHAPES = (("qwen3 B4xS512", 4, 40, 8, 512, 128, True, ("bf16", "f32")),
          ("whisper-enc", 4, 20, 20, 1500, 64, False, ("bf16",)))
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
                     "flash_attention_bwd"])
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    rng = np.random.default_rng(29)
    cases = []          # (label, fn, symbol, kernels a call or None)
    for where, B, H, K, S, hd, causal, dtypes in SHAPES:
        arrs = [torch.from_numpy(rng.standard_normal(
            (B, S, n, hd), dtype=np.float32)).cuda() for n in (H, K, K, H)]
        for dt in dtypes:
            q, k, v, do = (x.to(dts[dt]).transpose(1, 2) for x in arrs)
            out, lse = fa.flash_attention(q, k, v, causal, lse=True)
            ql, kl, vl = (x.detach().contiguous().requires_grad_(True)
                          for x in (q, k, v))
            out_l = F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=causal, enable_gqa=True)
            cases.append((
                f"{where} {dt} kernel",
                lambda q=q, k=k, v=v, out=out, do=do, lse=lse, c=causal:
                fa.flash_attention_bwd(q, k, v, out, do, lse, c),
                "flash_attention_bwd", 3))
            cases.append((
                f"{where} {dt} SDPA",
                lambda o=out_l, x=(ql, kl, vl), do=do:
                torch.autograd.grad(o, x, do, retain_graph=True), "", None))

    def probe(when: str) -> None:
        for label, fn, symbol, per_call in cases:
            print(f"{when} {label}: " + cs.timing_probe(
                torch, fn, symbol, per_call), flush=True)

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
