"""The port's dry run (repro_torch/launch/dryrun.py, analysis/op_count.py)
against the reference's (repro/launch/dryrun.py, results/dryrun.json):

  * every ``ok`` cell of results/dryrun.json: the port's argument bytes a
    device on the same 16x16 grid equal the reference's. The plan's specs
    are fitted (``fit_tree`` drops an axis a dimension does not divide
    by), so no shard is uneven and XLA adds no padding: the test computes
    that padding, 0, and holds the rest equal to the byte. Of the
    parameters, only those the step reads count, as ``jax.jit`` drops
    unused arguments (a decode step reads no encoder weight; mamba2 reads
    no ``ln2``; a train step takes a new parameter from its f32 master);
    which ones, a trace of the smoke config's same step says, and the
    full trace of three cells agrees;
  * the FLOPs of a smoke prefill traced on the meta device equal
    ``FlopCounterMode`` over the same step on CPU tensors, once the flash
    kernel's tiles are swapped for the plain version's S x S;
  * the reference's dry run of two smoke cells, in a subprocess (its
    module forces 512 host devices), on a one-device mesh with Auto axes
    (this JAX's Explicit production axes refuse its sharding constraints;
    at smoke size a 16-way axis divides neither the batch of 4 nor the
    heads, so its per-device count would not be global / devices): the
    decode step's FLOPs equal, the prefill's after the same swap;
  * the flash kernel's FLOP formulas, the meta ops, the CLI and the
    committed results/dryrun_torch.json;
  * the fault the dry run's trace of whisper's train step showed:
    ``jit_train_step`` (ZeRO-3) gave whisper's encoder no gradient.
"""
import dataclasses
import functools
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import op_count
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = json.loads((ROOT / "results" / "dryrun.json").read_text())
OK_CELLS = sorted(k for k, r in REF.items() if r["status"] == "ok")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid():
    return dryrun.production_grid(False)


def _pattern(name: str) -> str:
    return re.sub(r"^(layers|enc_layers)\.\d+\.", r"\1.*.", name)


@functools.lru_cache(maxsize=None)
def _read_in_smoke(arch: str, shape_name: str) -> frozenset:
    """The parameters (layer index as *) the smoke step of the cell reads,
    traced on one meta device."""
    g = dryrun.one_device(dryrun.production_grid(False))
    step, _, _, mem, _ = dryrun.lower_cell(arch, shape_name, smoke=True,
                                           grid=g)
    _, counts = op_count.count(step)
    return frozenset(_pattern(n) for n, t in mem["params"][1].items()
                     if op_count.storage_key(t) in counts["read"])


def _padding(p_sh, shapes) -> int:
    """The bytes XLA would pad uneven shards with on device 0."""
    pad = 0
    for n, t in shapes.items():
        counts = p_sh[n].counts(t.dim())
        padded = [-(-d // c) * c for d, c in zip(t.shape, counts)]
        pad += (int(np.prod(padded)) - t.numel()) // int(np.prod(counts)) \
            * t.element_size()
    return pad


@pytest.mark.parametrize("key", [k for k in OK_CELLS
                                 if not k.startswith("hog_svm_coproc")])
def test_argument_bytes_match_the_references(key, grid):
    arch, shape_name = key.split("|")[:2]
    arg, p_sh, shapes = dryrun.argument_plan(arch, shape_name, grid)
    read = _read_in_smoke(arch, shape_name)
    used = {n: t for n, t in shapes.items() if _pattern(n) in read}
    got = arg + dryrun.most_bytes({n: p_sh[n] for n in used}, used)
    assert _padding(p_sh, shapes) == 0
    assert got == REF[key]["mem"]["argument_bytes"], (
        key, got - REF[key]["mem"]["argument_bytes"])


@pytest.mark.parametrize("arch,shape_name", [
    ("whisper-large-v3", "decode_32k"), ("mamba2-130m", "decode_32k"),
    ("hog_svm_coproc", "train_4k")])
def test_full_trace_counts_the_references_arguments(arch, shape_name):
    row = dryrun.run_cell(arch, shape_name)
    want = REF[f"{arch}|{shape_name}|single|baseline"]
    assert row["mem"]["argument_bytes"] == want["mem"]["argument_bytes"]
    assert row["status"] == "ok" and row["mesh"] == "16x16"
    for k in ("name", "t_compute_s", "t_memory_s", "t_coll_s",
              "bottleneck", "step_time_s", "flops_dev", "mem_bytes_dev",
              "coll_bytes_dev", "model_flops_dev", "useful_flops_frac",
              "mfu", "arch", "shape", "mesh", "profile", "smoke", "lower_s",
              "compile_s", "mem", "coll_detail", "cost_flops_raw"):
        assert k in row, k
    assert sorted(row["mem"]) == sorted(want["mem"])
    m = row["mem"]
    assert m["peak_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                               + m["temp_bytes"] - m["alias_bytes"])


def _flash_swap(counts, calls) -> float:
    """FLOPs with each flash op's kernel tiles replaced by the plain
    version's S x S scores (2 products of 2 hd a score), as
    ``FlopCounterMode`` counts the plain einsums."""
    kernel = counts["flops_by_op"].get("repro_torch.flash_attention_fwd", 0)
    plain = sum(4 * B * H * S * S * hd for B, H, S, hd in calls)
    return counts["flops"] - kernel + plain


def _flash_calls(cfg, B, S):
    from repro_torch.models.model import layer_windows
    n = sum(w == 0 for w in layer_windows(cfg))
    return [(B, cfg.n_heads, S, cfg.hd)] * n


@pytest.mark.parametrize("arch", ["qwen3-14b", "olmoe-1b-7b"])
def test_meta_flops_equal_cpu_flops_of_the_same_step(arch):
    from repro_torch.models.model import init_params, prefill
    cfg = get_config(arch, smoke=True)
    B, S = 4, 32
    out = {}
    for dev in ("meta", "cpu"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        x = torch.zeros((B, S), dtype=torch.int64, device=dev)
        _, out[dev] = op_count.count(
            lambda: prefill(params, {"tokens": x}, cfg, S))
    assert "repro_torch.flash_attention_fwd" in out["meta"]["flops_by_op"]
    assert "repro_torch.flash_attention_fwd" not in out["cpu"]["flops_by_op"]
    assert _flash_swap(out["meta"], _flash_calls(cfg, B, S)) == \
        out["cpu"]["flops"]
    # nothing is allocated on the meta device: every byte is counted live
    assert out["meta"]["peak_bytes"] > 0


_REF_CELLS = r"""
import json, sys
import repro.launch.dryrun as rd     # forces 512 host devices first
import jax
auto = jax.sharding.AxisType.Auto


def one_device(*, multi_pod=False):
    shape = (1, 1, 1) if multi_pod else (1, 1)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(auto,) * len(shape))


rd.make_production_mesh = one_device
print(json.dumps({s: rd.run_cell("qwen3-14b", s, False, smoke=True)
                  ["flops_dev"] for s in ("prefill_32k", "decode_32k")}))
"""


def test_smoke_cells_against_the_references_dry_run():
    res = subprocess.run([sys.executable, "-c", _REF_CELLS],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu",
                                        "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr[-2000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    g = dryrun.one_device(dryrun.production_grid(False))
    cfg = get_config("qwen3-14b", smoke=True)
    got = {}
    for s in ref:
        step, _, _, _, _ = dryrun.lower_cell("qwen3-14b", s, smoke=True,
                                             grid=g)
        got[s] = op_count.count(step)[1]
    # decode: no flash; every matmul the same
    assert got["decode_32k"]["flops"] == ref["decode_32k"]
    # prefill: the kernel computes whole 128 x 128 causal tiles where the
    # reference's einsum attention computes the S x S scores (S 32: the
    # kernel's one tile is 16x the scores); the rest is the same
    assert got["prefill_32k"]["flops"] > ref["prefill_32k"]
    assert _flash_swap(got["prefill_32k"], _flash_calls(cfg, 4, 32)) == \
        ref["prefill_32k"]


def test_flash_flop_formulas_count_the_kernels_tiles():
    bf16, f32 = torch.bfloat16, torch.float32
    # sm90: 128 x 128 tiles; S 300 -> 3 query tiles seeing 1, 2, 3 tiles
    assert fa.kernel_flops(1, 1, 300, 64, bf16, True) == \
        4 * 64 * 6 * 128 * 128
    assert fa.kernel_flops(2, 3, 300, 64, bf16, False) == \
        4 * 64 * 2 * 3 * 9 * 128 * 128
    # cuda_core: 64 x 64 tiles (f32, or an hd off the sm90 list)
    assert fa.kernel_flops(1, 1, 300, 64, f32, True) == \
        4 * 64 * 15 * 64 * 64
    assert fa.kernel_flops(1, 1, 300, 32, bf16, True) == \
        4 * 32 * 15 * 64 * 64
    # backward, sm90: dK/dV 128-key tiles over 64-query steps from the
    # diagonal (5, 3, 1 steps), dQ 128 x 128 (6 tiles); 4 and 3 products
    assert fa.kernel_bwd_flops(1, 1, 300, 64, bf16, True) == \
        2 * 64 * (4 * 9 * 64 * 128 + 3 * 6 * 128 * 128)
    # cuda_core: 64 x 64 in both (15 tiles each, causal)
    assert fa.kernel_bwd_flops(1, 1, 300, 64, f32, True) == \
        2 * 64 * 7 * 15 * 64 * 64


def test_flash_on_meta_is_one_shape_only_op():
    """Inside ``shape_only`` (the dry run's traces) the wrappers take meta
    tensors; outside it they raise (tests/test_torch_flash.py)."""
    import repro_torch.kernels as kernels
    kernels.reset_launches()
    # (B, S, H, hd) projections seen as (B, H, S, hd), as prefill hands
    # them over
    q = torch.empty(2, 3, 4, 64, device="meta",
                    dtype=torch.bfloat16).transpose(1, 2)
    k = torch.empty(2, 3, 1, 64, device="meta",
                    dtype=torch.bfloat16).transpose(1, 2)
    with fa.shape_only():
        out = fa.flash_attention(q, k, k)
        assert out.device.type == "meta" and out.shape == q.shape \
            and out.stride() == q.stride()
        out, lse = fa.flash_attention(q, k, k, lse=True)
        assert lse.shape == (2, 4, 3) and lse.dtype == torch.float32
        qg = q.detach().requires_grad_()
        g = torch.autograd.grad(
            fa.FlashAttention.apply(qg, k, k, True).sum(), qg)
        assert g[0].shape == q.shape
    assert kernels.launch_counts()["flash_attention"] == 0
    assert kernels.launch_counts()["flash_attention_bwd"] == 0
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention(q, k, k)
    with pytest.raises(Exception, match="shape-only"):
        torch.ops.repro_torch.flash_attention_fwd(
            torch.zeros(1, 1, 8, 16), torch.zeros(1, 1, 8, 16),
            torch.zeros(1, 1, 8, 16), True, False)


def test_meta_is_a_device_of_the_entry_points():
    from repro_torch.core.detector import resolve_device
    from repro_torch.models.model import init_cache
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")
    c = init_cache(get_config("hymba-1.5b", smoke=True), 2, 16, "meta")
    assert c["k"].device.type == "meta" and c["idx"] == 0


def test_cli_writes_every_cell_and_resumes(tmp_path, capsys):
    out = tmp_path / "d.json"
    argv = ["--smoke", "--arch", "mamba2-130m", "--shape", "decode_32k",
            "--mesh", "both", "--out", str(out)]
    assert dryrun.main(argv) == 0
    rows = json.loads(out.read_text())
    assert sorted(rows) == [f"mamba2-130m|decode_32k|{m}|baseline"
                            for m in ("multi", "single")]
    assert {r["status"] for r in rows.values()} == {"ok"}
    assert {r["mesh"] for r in rows.values()} == {"16x16", "2x16x16"}
    assert dryrun.main(argv + ["--resume"]) == 0
    assert capsys.readouterr().out.count("[cached]") == 2
    out2 = tmp_path / "h.json"
    assert dryrun.main(["--smoke", "--arch", "qwen3-14b", "--shape",
                        "long_500k", "--out", str(out2)]) == 0
    (row,) = json.loads(out2.read_text()).values()
    assert row["status"] == "skip" and row["reason"] == (
        "SKIP(full-attn): 500k decode needs sub-quadratic attention")


def test_committed_dry_run_has_every_cell_of_the_references():
    rows = json.loads((ROOT / "results" / "dryrun_torch.json").read_text())
    for mesh in ("single", "multi"):
        mine = {k: r for k, r in rows.items() if f"|{mesh}|" in k}
        want = {k.replace("|single|", f"|{mesh}|") for k in REF}
        assert sorted(mine) == sorted(want)
        assert not [k for k, r in mine.items() if r["status"] == "error"]
        skips = {k: r["reason"] for k, r in mine.items()
                 if r["status"] == "skip"}
        assert sorted(skips) == sorted(
            k.replace("|single|", f"|{mesh}|") for k, r in REF.items()
            if r["status"] == "skip")
        assert set(skips.values()) == {r["reason"] for r in REF.values()
                                       if r["status"] == "skip"}
    for k in OK_CELLS:
        assert rows[k]["mem"]["argument_bytes"] == \
            REF[k]["mem"]["argument_bytes"], k


def test_zero3_trains_whisper_encoder():
    """Each layer of a sharded state is gathered inside its recomputed
    block (the reentrant checkpoint), which differentiates only through
    its tensor inputs: whisper's encoder runs on frames that need no
    gradient, so every encoder weight got none until the block's input
    was made to carry one (models/model.py:_remat)."""
    from repro_torch.launch.mesh import grid_of
    from repro_torch.models.model import loss_fn
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              jit_train_step, shard_state,
                                              state_shardings)
    cfg = dataclasses.replace(get_config("whisper-large-v3", smoke=True),
                              dtype=torch.float32)
    rng = np.random.default_rng(0)
    B, S = 2, 8
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S))),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S))),
             "enc_input": torch.as_tensor(rng.standard_normal(
                 (B, cfg.encoder_ctx, cfg.d_model), dtype=np.float32))}
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    grid = grid_of((torch.device("cpu"),) * 2, (2, 1), ("data", "model"))
    sh = state_shardings(grid, state, cfg)["params"]
    loss, acc = jit_train_step(cfg, OptConfig(), grid).grads(
        shard_state(state, state_shardings(grid, state, cfg)), batch)
    want = loss_fn(state["params"], batch, cfg)
    want.backward()
    want = float(want.detach())
    assert abs(float(loss) - want) <= 1e-6 * abs(want)
    for n, p in state["params"].named_parameters():
        owners = sh[n].owners(p.dim())
        got = sh[n].gather([acc[n][o] for o in owners])
        rel = float((got - p.grad).norm() / p.grad.norm())
        assert rel <= 1e-5, (n, rel)
    assert any(n.startswith("enc_layers.") for n in acc)


_REF_GRID_CELLS = r"""
import json
import repro.launch.dryrun as rd     # forces 512 host devices first
import jax
auto = jax.sharding.AxisType.Auto
out = {}
for shape in ((1, 4), (2, 2)):
    def mesh(*, multi_pod=False, shape=shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(auto,) * 2,
                             devices=jax.devices()[:4])
    rd.make_production_mesh = mesh
    out["%dx%d" % shape] = rd.run_cell("qwen3-14b", "train_4k", False,
                                       smoke=True)["mem"]["argument_bytes"]
print(json.dumps(out))
"""


def test_train_cell_over_model_traces_the_model_path():
    """A train_4k cell on a grid whose "model" axis is 4 or 2 traces the
    context-parallel step (one dp row of the grid's "model" axis, the
    row's share of the global batch): the "model" path once; the flash
    backward's FLOPs those of its chunks, ``kernel_bwd_flops`` at each
    chunk's offset against the whole sequence, summed over the chunks and
    the layers; its argument bytes the reference's dry run of the same
    smoke cell on the same (Auto) mesh."""
    from repro_torch.launch.mesh import grid_of
    from repro_torch.models import model as m
    res = subprocess.run([sys.executable, "-c", _REF_GRID_CELLS],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu",
                                        "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr[-2000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    cfg = get_config("qwen3-14b", smoke=True)
    for shape in ((1, 4), (2, 2)):
        grid = grid_of((dryrun.META,) * 4, shape, ("data", "model"))
        m.reset_paths()
        step, _, _, mem, _ = dryrun.lower_cell("qwen3-14b", "train_4k",
                                               smoke=True, grid=grid)
        _, counts = op_count.count(step)
        assert m.path_counts == {"whole": 0, "rows": 0, "model": 1}
        specs = dryrun._input_specs(cfg, dryrun.SHAPE_BY_NAME["train_4k"],
                                    True, 0)
        B, S = specs["tokens"].shape
        B //= shape[0]
        tp = shape[1]
        c = S // tp
        want = cfg.n_layers * sum(
            fa.kernel_bwd_flops(B, cfg.n_heads, c, cfg.hd, cfg.dtype, True,
                                Sk=S, q_offset=g * c) for g in range(tp))
        assert counts["flops_by_op"]["repro_torch.flash_attention_bwd"] \
            == want
        row = dryrun.run_cell("qwen3-14b", "train_4k", smoke=True,
                              grid=grid)
        assert row["mem"]["argument_bytes"] == ref["%dx%d" % shape], shape
