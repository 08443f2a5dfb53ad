#!/usr/bin/env python3
"""Device time of the widened dense scorer (3 stacked heads, N = 315) on
one GPU: the launch plan's grid against other grids per head, and against
three one-head launches.

    python3 tools/score_heads.py

For each pyramid level of a 640x480 frame (M = 4524, 2852, 1813 block
rows) and the largest 1280x720 level (M = 14220), in f32, bf16 and int8,
``score_matmul`` / ``score_matmul_int8`` runs on seeded operands with
``kernels/svm_matmul.py:score_plan``'s grid of 132 / 3 = 44 CTAs a head
and with 66 and 132 a head (the pass sizes, threads and shared memory
re-derived for each, as the launcher requires), each checked equal to
the plan's output; then the three heads as three one-head launches.
Prints the card, then one line per level and dtype: device us of each
(torch.profiler, 20 calls).
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
HEADS, NH, K = 3, 105, 36
ROWS = (4524, 2852, 1813, 14220)
GRIDS = (44, 66, 132)


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    import repro_torch.kernels.build as build
    import repro_torch.kernels.svm_matmul as sm
    if not torch.cuda.is_available():
        print("score_heads: no GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = HEADS * NH
    for M in ROWS:
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            int8 = dt == torch.int8
            name = "score_matmul_int8" if int8 else "score_matmul"
            if int8:
                x = torch.randint(-127, 128, (M, K), generator=gen,
                                  device="cuda", dtype=torch.int8)
                w = torch.randint(-127, 128, (K, n), generator=gen,
                                  device="cuda", dtype=torch.int8)
            else:
                x = torch.rand((M, K), generator=gen, device="cuda").to(dt)
                w = torch.randn((K, n), generator=gen, device="cuda").to(dt)
            fn = sm.score_matmul_int8 if int8 else sm.score_matmul
            want = fn(x, w, HEADS)
            out = torch.empty_like(want)
            units = -(-M // 4)
            times = {}
            for g in GRIDS:
                most = -(-units // g)
                npass = -(-most // (sm.SCORE_THREADS // -(-NH // 4)))
                pu = -(-most // npass)
                threads = -(-pu * -(-NH // 4) // 32) * 32
                smem = sm.score_smem_bytes(K, NH, dt.itemsize, pu)
                extra = () if int8 else (sm._DTYPE_CODES[dt],)
                args = sm._ARGTYPES_I8 if int8 else sm._ARGTYPES

                def launch(g=g, pu=pu, threads=threads, smem=smem,
                           extra=extra, args=args):
                    build.launch(name, args, x, x.data_ptr(), w.data_ptr(),
                                 out.data_ptr(), M, K, n, *extra, g, HEADS,
                                 pu, threads, smem,
                                 sm.vec_flags(x, w, out, HEADS))
                launch()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    print(f"score_heads: grid {g} differs at M {M} {dt}",
                          file=sys.stderr)
                    return 1
                times[f"grid {g}"] = cs.kernel_device_ms(
                    torch, launch, name + "_kernel")
            ones = [w[:, NH * k:NH * (k + 1)].contiguous()
                    for k in range(HEADS)]
            times["3 one-head launches"] = cs.kernel_device_ms(
                torch, lambda: [fn(x, o) for o in ones], name + "_kernel")
            print(f"M {M} {str(dt)[6:]}: " + ", ".join(
                f"{k} {v * 1e3:.2f} us" for k, v in times.items()),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
