"""How far mamba2's decode over "model" drifts from the whole model, step
by step, and what the drift comes from: mamba2-130m (24 layers, full
width, seeded random weights held as shards) on a (1, 4) grid of logical
devices of one card, B 4 x S 512, 16 greedy steps, as chip_smoke.py's
phase 5d serves it, in five runs:

  * bf16, as the port decodes (``models/model.py:_tp_ssm_decode``: each
    device's ``in_proj`` columns, ``_cols``, gathered; ``out_proj``'s row
    partial sums added in f32 in model-index order and rounded once,
    ``_rows``);
  * bf16 with each SSM ``out_proj`` done whole instead (its pieces and
    the gated norm's output gathered onto every device and multiplied as
    the whole model multiplies them), with ``in_proj`` done whole (its
    column pieces joined, the token's whole product on every device), and
    with both;
  * f32, as the port decodes.

Each run against the same weights whole under the same ctx: the relative
L2 of each step's logits over the rows whose tokens agree so far (the
prefill's last logits first), printed one run a line, then the card's
name and power limit and a JSON object of the runs.

    python3 tools/ssm_decode_witness.py
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCH, LAYERS, B, S, NEW, MODEL = "mamba2-130m", 24, 4, 512, 16, 4


RUNS = (("bf16", "bfloat16", ()),
        ("bf16 out_proj whole", "bfloat16", ("out_proj",)),
        ("bf16 in_proj whole", "bfloat16", ("in_proj",)),
        ("bf16 in_proj and out_proj whole", "bfloat16",
         ("in_proj", "out_proj")),
        ("f32", "float32", ()))


def per_step(torch, np, cs, dtype, whole=()):
    """The run's relative L2 of each step's logits against the whole
    model's (rows of the same tokens) and whether its greedy tokens equal
    the whole model's; the SSM projections named in ``whole`` done whole
    in decode."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.models.model import init_params, param_shapes
    from repro_torch.sharding.rules import make_ctx, param_shardings

    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS,
                              dtype=dtype)
    grid = make_host_mesh(MODEL, cs.DEV)
    assert grid.shape == (1, MODEL), grid.shape
    ctx = make_ctx(grid)
    sharded = init_params(cfg, torch.Generator(device=cs.DEV).manual_seed(0),
                          cs.DEV, param_shardings(grid, param_shapes(cfg),
                                                  cfg))
    params = cs.whole_of(torch, sharded)
    x = np.random.default_rng(2).integers(0, cfg.vocab, (B, S))
    t_wh, l_wh = cs.mesh_generate(torch, params, cfg, x, NEW, ctx)
    rows, cols = lm._rows, lm._cols

    def joined(row, name, dim):
        return torch.cat([t.to(row.devices[0]) for t in row.local(name)],
                         dim)

    def rows_whole(row, name, xs, split):
        if not name.endswith("ssm.out_proj") or row.model_dim(name) is None:
            return rows(row, name, xs, split)
        xs, w = lm._full(row, xs, split), joined(row, name, 0)
        return lm.on_devices(row.devices, lambda g: torch.matmul(
            xs[g], w.to(row.devices[g])))

    def cols_whole(row, name, xs):
        if not name.endswith("ssm.in_proj") or row.model_dim(name) is None:
            return cols(row, name, xs)
        w = joined(row, name, -1)
        return lm.on_devices(row.devices, lambda g: torch.matmul(
            xs[g], w.to(row.devices[g]))), False

    if "out_proj" in whole:
        lm._rows = rows_whole
    if "in_proj" in whole:
        lm._cols = cols_whole
    try:
        lm.reset_paths()
        t_sh, l_sh = cs.mesh_generate(torch, sharded, cfg, x, NEW, ctx)
        assert lm.path_counts["model"] > 0, lm.path_counts
    finally:
        lm._rows, lm._cols = rows, cols
    ok = torch.ones_like(t_sh, dtype=torch.bool)
    ok[:, 1:] = torch.cumprod((t_sh == t_wh).int(), 1)[:, :-1].bool()
    diff = l_sh - l_wh
    rel = (diff.square().sum(-1) * ok).sum(0).sqrt() / (
        l_wh.square().sum(-1) * ok).sum(0).sqrt().clamp(min=1e-30)
    return {"per_step": rel.tolist(), "tokens_equal": bool(
        torch.equal(t_sh, t_wh)), "rows_compared": ok.sum(0).tolist()}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.environ["REPRO_TEST_DEVICES"] = str(MODEL)
    import chip_smoke as cs
    out = {}
    for name, dtype, whole in RUNS:
        out[name] = per_step(torch, np, cs, getattr(torch, dtype), whole)
        print(f"{ARCH} {LAYERS}L (1, {MODEL}) B{B}xS{S}, {NEW} steps, "
              f"{name}: sharded vs whole rel L2 a step "
              + " ".join(f"{r:.2e}" for r in out[name]["per_step"])
              + f"; tokens equal {out[name]['tokens_equal']}", flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
