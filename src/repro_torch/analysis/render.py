"""Markdown tables of the port's dry run (port of
repro/analysis/render.py), from results/dryrun_torch.json.

    PYTHONPATH=src python -m repro_torch.analysis.render [dryrun|roofline]
        [profile] [path]
"""
from __future__ import annotations

import json
import sys

DEFAULT = "results/dryrun_torch.json"


def dryrun_table(path: str = DEFAULT, profile: str = "baseline") -> str:
    with open(path) as f:
        rows = json.load(f)
    out = ["| arch | shape | mesh | trace_s | peak GiB/dev | arg GiB | "
           "status |", "|---|---|---|---|---|---|---|"]
    for k in sorted(rows):
        r = rows[k]
        if r.get("profile") != profile:
            continue
        if r.get("status") == "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"{r['lower_s']} | {r['mem']['peak_bytes']/2**30:.2f} | "
                f"{r['mem']['argument_bytes']/2**30:.2f} | ok |")
        elif r.get("status") == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | -- | "
                       f"-- | -- | {r['reason'].split(':')[0]} |")
    return "\n".join(out)


def roofline_table(path: str = DEFAULT, profile: str = "baseline") -> str:
    with open(path) as f:
        rows = json.load(f)
    out = ["| arch | shape | mesh | T_comp (s) | T_mem (s) | T_coll (s) | "
           "bottleneck | 6ND/counted | MFU |",
           "|---|---|---|---|---|---|---|---|---|"]
    for k in sorted(rows):
        r = rows[k]
        if r.get("profile") != profile or r.get("status") != "ok":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['t_compute_s']:.3f} | {r['t_memory_s']:.3f} | "
            f"{r['t_coll_s']:.3f} | {r['bottleneck']} | "
            f"{r['useful_flops_frac']:.2f} | {r['mfu']:.3f} |")
    return "\n".join(out)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "roofline"
    profile = sys.argv[2] if len(sys.argv) > 2 else "baseline"
    path = sys.argv[3] if len(sys.argv) > 3 else DEFAULT
    if which == "dryrun":
        print(dryrun_table(path, profile=profile))
    else:
        print(roofline_table(path, profile=profile))
