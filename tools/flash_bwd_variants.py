#!/usr/bin/env python3
"""Versions of the sm90 flash backward side by side on one GPU, to try a
change to csrc/flash_attention_bwd_sm90.cu against the kernel as it is:

    python3 tools/flash_bwd_variants.py [NAME=PATH ...] [--compile-only]

Each NAME=PATH is a copy of the source with a change (its directory
holds the sm90_wgmma.cuh it includes); the repository's own source runs
as "repo". Every version is built with build.py's flags, and ptxas's
spills are printed per function (--compile-only stops there). Then, at
small shapes (ragged S, causal and not, hd 16 / 64 / 128) and at the
timed ones of chip_smoke.py's backward check (qwen3-14b's B 4 x S 512
and B 1 x S 2,048, hymba's, whisper's encoder), each version runs with
the plan's head groups, one group and rep groups: its relative L2 to
the plain backward, whether a rerun is bit-identical, and at the timed
shapes CUDA-event ms per call and torch.profiler's device us per kernel.
SDPA's backward is timed beside them, and the card's name and power
limit printed first.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# name, B, H, K, S, hd, causal, timed
CASES = (("small", 2, 8, 2, 64, 16, False, False),
         ("s100", 2, 8, 2, 100, 16, True, False),
         ("ragged64", 2, 8, 2, 300, 64, True, False),
         ("ragged128", 2, 8, 2, 300, 128, True, False),
         ("B4xS512", 4, 40, 8, 512, 128, True, True),
         ("B1xS2048", 1, 40, 8, 2048, 128, True, True),
         ("hymba", 1, 25, 5, 2176, 64, True, True),
         ("whisper-enc", 4, 20, 20, 1500, 64, False, True))


def build_versions(build, versions: dict) -> dict:
    """Compile each source (one nvcc each, all at once) into build/;
    print spilling functions; return {name: the C entry point}."""
    procs = {}
    for name, src in versions.items():
        out = build.BUILD_DIR / f"libflash_bwd_variant-{name}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    fns = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0].splitlines()
        clean = sum("0 bytes spill stores, 0 bytes spill loads" in ln
                    for ln in log)
        print(f"{name}: nvcc exit {proc.returncode}, {clean} functions "
              f"without spills", flush=True)
        for prev, ln in zip([""] + log, log):
            if ("spill" in ln and "0 bytes spill stores, 0 bytes spill "
                    "loads" not in ln) or "error" in ln:
                print(f"  {prev.split('for ')[-1][:100]} | {ln.strip()}",
                      flush=True)
        if proc.returncode == 0:
            fn = ctypes.CDLL(str(out)).flash_attention_bwd_sm90_launch
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def main() -> int:
    sys.path[:0] = [str(ROOT / "src")]
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.kernels.build as build
    import repro_torch.kernels.flash_attention as fa

    args = [a for a in sys.argv[1:] if a != "--compile-only"]
    versions = {"repo": build.CSRC / build.SOURCES["flash_attention_bwd_sm90"]}
    versions.update(a.split("=", 1) for a in args)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    fns = build_versions(build, versions)
    if "--compile-only" in sys.argv or not torch.cuda.is_available():
        return 0 if len(fns) == len(versions) else 1
    for fn in fns.values():
        fn.argtypes = list(fa._BWD_SM90_ARGTYPES)

    def run(fn, q, k, v, out, do, lse, causal, groups):
        B, H, S, hd = q.shape
        K = k.shape[1]
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        pad = -(-S // fa.SM90_BWD_PAD) * fa.SM90_BWD_PAD
        pairs = torch.empty((B, H, pad, 2), dtype=torch.float32,
                            device=q.device)
        part = torch.empty((2, groups, B, K, S, hd), dtype=torch.float32,
                           device=q.device)
        st = (ctypes.c_longlong * 24)(*[
            s for t in (q, k, v, out, do, dq, dk, dv) for s in t.stride()[:3]])
        rc = fn(*(t.data_ptr() for t in (q, k, v, out, do)), lse.data_ptr(),
                pairs.data_ptr(), part.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, H, K, S, hd, int(causal),
                groups, ctypes.addressof(st),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"launch failed with cudaError {rc}")
        return dq, dk, dv

    def rel(a, b):
        return float((a.float() - b.float()).norm()
                     / b.float().norm().clamp(min=1e-30))

    def ev_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def per_kernel(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return ", ".join(
            f"{e.key.split('(')[0].split()[-1][:40]} {e.count}x"
            f"{e.self_device_time_total / max(e.count, 1):.1f}us"
            for e in prof.key_averages() if "flash_attention_bwd" in e.key)

    rng = np.random.default_rng(0)
    for where, B, H, K, S, hd, causal, timed in CASES:
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (B, S, n, hd), dtype=np.float32)).cuda().bfloat16().transpose(
                1, 2) for n in (H, K, K, H))
        out, lse = fa.flash_attention(q, k, v, causal, lse=True)
        want = fa.flash_attention_bwd_plain(q, k, v, do, lse, causal)
        plan = fa.bwd_plan_sm90(B, H, K, S, causal,
                                build.sm_count(0))["groups"]
        line = [f"{where}:"]
        for name, fn in fns.items():
            for groups in dict.fromkeys((plan, 1, H // K)):
                got = run(fn, q, k, v, out, do, lse, causal, groups)
                again = run(fn, q, k, v, out, do, lse, causal, groups)
                torch.cuda.synchronize()
                text = (f"{name} g{groups}{' (plan)' if groups == plan else ''}"
                        f" err {max(rel(g, w) for g, w in zip(got, want)):.2e}"
                        f" same {all(map(torch.equal, got, again))}")
                if timed:
                    call = (lambda fn=fn, g=groups:
                            run(fn, q, k, v, out, do, lse, causal, g))
                    text += (f" ev {ev_ms(call):.4f} ms "
                             f"[{per_kernel(call)}]")
                line.append(text)
        if timed:
            ql, kl, vl = (x.detach().contiguous().requires_grad_(True)
                          for x in (q, k, v))
            ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                                enable_gqa=True)
            line.append("SDPA ev %.4f" % ev_ms(lambda: torch.autograd.grad(
                ol, (ql, kl, vl), do, retain_graph=True)))
        print("; ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
