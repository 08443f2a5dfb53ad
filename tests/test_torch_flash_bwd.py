"""The gradient of the port's flash attention on CPU tensors -- its plain
backward ``flash_attention_bwd_plain`` and the autograd Function
``FlashAttention`` training takes -- against the reference's two
gradients on the same numpy-seeded inputs: ``jax.vjp`` of
repro.models.attention.sdpa_flash (whose custom VJP, _flash_bwd, the
plain backward repeats step for step) and of the oracle
repro.kernels.ref.flash_attention_ref (autodiff of the softmax). The
CUDA kernel (csrc/flash_attention_bwd.cu) runs only on the card:
chip_smoke.py holds it to the plain version there.

Tolerance: f32 1e-5 relative L2 (summation order; the reference's two
gradients agree to 2.4e-6 with each other at these shapes). The LSE that
the forward saves is held to _flash_fwd_impl's at 1e-5.
"""
import ast
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro.models.attention import _flash_fwd_impl, sdpa_flash
from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import _sdpa, attend, make_mask
from repro_torch.models.configs import ModelConfig

TOL = 1e-5
SRC = build.CSRC / "flash_attention_bwd.cu"
SRC_SM90 = build.CSRC / "flash_attention_bwd_sm90.cu"

torch.set_num_threads(1)


def _inputs(B, H, K, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((B, H, S, hd), (B, K, S, hd), (B, K, S, hd), (B, H, S, hd))]


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _mask(B, S, causal):
    pos = jnp.arange(S)
    m = pos[None, :] <= pos[:, None] if causal else jnp.ones((S, S), bool)
    return jnp.broadcast_to(m, (B, S, S))


def _ref_sdpa_flash(q, k, v, do, causal):
    """jax.vjp of sdpa_flash in its (B, S, K, rep, hd) layout, returned in
    the port's (B, H, S, hd) / (B, K, S, hd) layout."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    rep = H // K

    def to5(x):
        return jnp.asarray(x).reshape(B, K, rep, S, hd).transpose(
            0, 3, 1, 2, 4)

    kv = [jnp.asarray(x).transpose(0, 2, 1, 3) for x in (k, v)]
    mask = _mask(B, S, causal)
    _, vjp = jax.vjp(lambda a, b, c: sdpa_flash(a, b, c, mask, hd ** -0.5),
                     to5(q), *kv)
    dq5, dk, dv = vjp(to5(do))
    dq = np.asarray(dq5).transpose(0, 2, 3, 1, 4).reshape(B, H, S, hd)
    return dq, np.asarray(dk).transpose(0, 2, 1, 3), \
        np.asarray(dv).transpose(0, 2, 1, 3)


def _ref_oracle(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda a, b, c: j_flash_ref(a, b, c, causal), q, k, v)
    return [np.asarray(g) for g in vjp(do)]


@pytest.fixture(scope="module")
def cases():
    """(causal, rep, S) -> inputs, the two reference gradients, the
    plain backward and FlashAttention's gradients; S 40 and a ragged 100
    (over a 64-row tile)."""
    out = {}
    for causal in (True, False):
        for rep in (1, 4):
            for S in (40, 100):
                q, k, v, do = _inputs(2, 2 * rep, 2, S, 16,
                                      seed=rep * 10 + S + causal)
                tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                              for x in (q, k, v))
                out_t = fa.FlashAttention.apply(tq, tk, tv, causal)
                out_t.backward(torch.from_numpy(do))
                _, lse = fa.flash_attention_plain(
                    *(torch.from_numpy(x) for x in (q, k, v)), causal,
                    lse=True)
                plain = fa.flash_attention_bwd_plain(
                    *(torch.from_numpy(x) for x in (q, k, v, do)), lse,
                    causal)
                out[causal, rep, S] = dict(
                    inputs=(q, k, v, do), lse=lse, plain=plain,
                    func=(tq.grad, tk.grad, tv.grad),
                    flash=_ref_sdpa_flash(q, k, v, do, causal),
                    oracle=_ref_oracle(q, k, v, do, causal))
    return out


KEYS = [(c, r, s) for c in (True, False) for r in (1, 4) for s in (40, 100)]


@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"causal{k[0]}-rep{k[1]}"
                         f"-S{k[2]}")
@pytest.mark.parametrize("ours", ["plain", "func"])
@pytest.mark.parametrize("ref", ["flash", "oracle"])
def test_gradients_match_reference(cases, key, ours, ref):
    c = cases[key]
    for name, got, want in zip("qkv", c[ours], c[ref]):
        assert _rel(got, want) <= TOL, (name, _rel(got, want))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 4])
def test_lse_matches_reference_fwd_impl(cases, causal, rep):
    c = cases[causal, rep, 100]
    q, k, v, _ = c["inputs"]
    B, H, S, hd = q.shape
    K = k.shape[1]
    q5 = jnp.asarray(q).reshape(B, K, rep, S, hd).transpose(0, 3, 1, 2, 4)
    _, want = _flash_fwd_impl(q5, jnp.asarray(k).transpose(0, 2, 1, 3),
                              jnp.asarray(v).transpose(0, 2, 1, 3),
                              _mask(B, S, causal), hd ** -0.5)
    want = np.asarray(want).reshape(B, H, S)
    np.testing.assert_allclose(c["lse"].numpy(), want, rtol=TOL, atol=TOL)


def test_function_saves_lse_and_runs_plain_on_cpu_without_counting():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 24, 8))
    kernels.reset_launches()
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = fa.FlashAttention.apply(qq, kk, vv, True)
    torch.testing.assert_close(out.detach(), fa.flash_attention_plain(q, k, v),
                               rtol=0, atol=0)
    out.backward(do)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 0
    lse = fa.flash_attention(q, k, v, lse=True)[1]
    want = fa.flash_attention_bwd(q, k, v, out.detach(), do, lse)
    for got, w in zip((qq.grad, kk.grad, vv.grad), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_attend_takes_the_function_only_where_grad_is_enabled():
    """Training (grad on) differentiates through FlashAttention and agrees
    with autograd through _sdpa under the causal mask; serving (inference
    mode) gets the same output with no graph."""
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2) for x in
                   _inputs(2, 8, 2, 40, 16, seed=3))
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=128,
                      n_heads=8, n_kv_heads=2, d_ff=8, vocab=8, head_dim=16,
                      dtype=torch.float32)
    pos = torch.arange(40).expand(2, 40)
    grads = []
    for fn in (lambda a, b, c: attend(a, b, c),
               lambda a, b, c: _sdpa(a, b, c, make_mask(pos, pos), cfg)):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs)
        out.backward(do)
        grads.append([x.grad for x in xs])
    for got, want in zip(*grads):
        assert _rel(got, want.numpy()) <= TOL
    with torch.inference_mode():
        served = attend(q, k, v)
    assert not served.requires_grad
    torch.testing.assert_close(served, attend(q, k, v).detach(), rtol=0,
                               atol=0)


def test_backward_wrapper_raises_on_bad_inputs():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 8, 16))
    lse = fa.flash_attention(q, k, v, lse=True)[1]
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd(q, k, v, q, do[:, :, :7], lse)
    with pytest.raises(ValueError, match="out"):
        fa.flash_attention_bwd(q, k, v, q.double(), do, lse)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, q, do, lse.double())
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, q, do, lse[:, :2])
    meta = [x.to("meta") for x in (q, k, v, q, do, lse)]
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention_bwd(*meta)


def test_backward_shared_memory_request_mirrors_the_source():
    """Four f32 tiles of 64 rows at stride hd + 1, the 64 x 65 w / ds
    tile, 64 lse and 64 delta values: 149,248 bytes at hd 128, over the
    48 KB default and under Hopper's opt-in, at every hd it takes."""
    assert fa.bwd_smem_bytes(128) == 4 * (4 * 64 * 129 + 64 * 65 + 128)
    assert fa.bwd_smem_bytes(128) == 149248
    assert fa.bwd_smem_bytes(128) > build.SMEM_DEFAULT
    assert max(map(fa.bwd_smem_bytes, range(8, 129, 8))) <= build.SMEM_OPTIN
    src = SRC.read_text()
    assert re.search(r"return 4 \* 64 \* \(hd \+ 1\) \+ 64 \* \(BQ \+ 1\) "
                     r"\+ 2 \* 64;", src)
    for name, value in (("BQ", fa.BLOCK_Q), ("BK", fa.BLOCK_K),
                        ("MAX_HD", fa.MAX_HD)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


def test_backward_source_pins():
    """No atomics (a rerun is bit-identical), expf and never __expf, the
    three kernels the profiler's symbol matches, the C entry point
    build.launch calls, and the note of the gradient it computes."""
    src = SRC.read_text()
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", src)
    assert "expf(" in src and not re.search(r"__expf\s*\(", src)
    for needle in ("flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
                   "flash_attention_bwd_dq", "flash_attention_bwd_launch",
                   "repro/models/attention.py:359", "_flash_bwd"):
        assert needle in src, needle
    assert build.SOURCES["flash_attention_bwd"] == "flash_attention_bwd.cu"
    assert kernels.wrappers()["flash_attention_bwd"] is fa.flash_attention_bwd


def test_backward_has_no_fallback():
    """A build or launch failure raises: no try/except in the backward
    wrapper, either route's launcher or the Function."""
    tree = ast.parse(inspect.getsource(fa))
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef)}
    for name in ("flash_attention_bwd", "backward", "forward",
                 "launch_bwd_sm90", "launch_bwd_cuda_core", "_count_bwd"):
        assert not any(isinstance(n, ast.Try)
                       for n in ast.walk(funcs[name])), name


def test_forward_lse_is_asked_for_only_by_training():
    """Serving's calls pass no LSE buffer: flash_attention returns a bare
    tensor unless lse=True."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 8, 8))
    assert isinstance(fa.flash_attention(q, k, v), torch.Tensor)
    out, lse = fa.flash_attention(q, k, v, causal=False, lse=True)
    assert lse.shape == (1, 2, 8) and lse.dtype == torch.float32
    assert fa._lse_buffer(q, False) == (None, 0)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.float32, 128, "cuda_core"), (torch.float32, 64, "cuda_core"),
    (torch.float32, 16, "cuda_core"), (torch.bfloat16, 16, "sm90"),
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 32, "cuda_core")])
def test_backward_route_is_the_forwards(dtype, hd, want):
    """The backward takes the route the forward takes: the tensor cores
    for bf16 at hd 16, 64 and 128, CUDA cores for f32 and other hd."""
    assert fa.route(dtype, hd) == want


def test_backward_dispatch_goes_by_route_alone():
    """flash_attention_bwd's CUDA branch launches launch_bwd_sm90 where
    route() says "sm90" and launch_bwd_cuda_core otherwise; each launcher
    counts its own route once, and the plain backward is reached only
    for CPU tensors."""
    tree = ast.parse(inspect.getsource(fa))
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def calls(name):
        return [n.func.id for n in ast.walk(funcs[name])
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]

    top = calls("flash_attention_bwd")
    assert {"route", "launch_bwd_sm90", "launch_bwd_cuda_core",
            "flash_attention_bwd_plain"} <= set(top)
    src = inspect.getsource(fa.flash_attention_bwd).split('"""')[2]
    assert src.index('q.device.type == "cpu"') \
        < src.index("flash_attention_bwd_plain") < src.index("route(")
    for name, r in (("launch_bwd_sm90", "sm90"),
                    ("launch_bwd_cuda_core", "cuda_core")):
        assert "flash_attention_bwd_plain" not in calls(name)
        assert calls(name).count("_count_bwd") == 1
        assert f'_count_bwd("{r}")' in inspect.getsource(getattr(fa, name))
    kernels.reset_launches()
    assert fa.flash_attention_bwd.route_launches == dict.fromkeys(
        fa.ROUTES, 0)


def test_sm90_backward_launcher_refuses_what_it_was_not_built_for():
    q = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="sm90"):
        fa.launch_bwd_sm90(q, q, q, q, q, lse)
    f = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="sm90"):
        fa.launch_bwd_sm90(f, f, f, f, f, lse)
    b = torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):
        fa.launch_bwd_sm90(b, b, b, b, b, lse)


@pytest.mark.parametrize("hd", fa.SM90_HD)
def test_sm90_backward_shared_memory_mirrors_the_source(hd):
    """KvGeo::SMEM (K, V, two stages of Q and do tiles and their (lse,
    delta) pairs, five mbarriers) and QGeo::SMEM (Q, do, two stages of K
    and V tiles, five mbarriers) at each hd the route is built for: over
    the 48 KB default at hd 128, under Hopper's opt-in at all."""
    dkdv, dq = fa.bwd_smem_bytes_sm90(hd)
    assert dkdv == 1024 + 2 * hd * (2 * 128 + 2 * 2 * 64) + 2 * 64 * 8 + 40
    assert dq == 1024 + 2 * hd * (2 * 128 + 2 * 2 * 128) + 40
    assert max(dkdv, dq) <= build.SMEM_OPTIN
    if hd == 128:
        assert (dkdv, dq) == (133160, 197672)
        assert min(dkdv, dq) > build.SMEM_DEFAULT
    src = SRC_SM90.read_text()
    for name, value in (("BKV", fa.SM90_BWD_BLOCK_KV),
                        ("BQ", fa.SM90_BWD_BLOCK_Q),
                        ("DQ_BQ", fa.SM90_BWD_DQ_BLOCK_Q),
                        ("DQ_BK", fa.SM90_BWD_DQ_BLOCK_K),
                        ("STAGES", fa.SM90_BWD_STAGES),
                        ("PAD", fa.SM90_BWD_PAD)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    for geo in ("LD_BYTES = BQ \\* 8;",
                "LD_OFF = 2 \\* KV_BYTES \\+ 2 \\* STAGES \\* QT_BYTES;",
                "BAR_OFF = 2 \\* Q_BYTES \\+ 2 \\* STAGES \\* KV_BYTES;",
                "SMEM = 1024 \\+ BAR_OFF \\+ 8 \\* \\(1 \\+ 2 \\* STAGES\\)"):
        assert re.search(geo, src), geo
    assert re.search(rf"case {hd}:\s*return launch<{hd}>", src)


def test_sm90_backward_source_pins():
    """No atomics (a rerun is bit-identical); expf, never __expf; the
    tensor cores, TMA and the register split; every kernel's name holds
    the symbol the profiler matches; the C entry point build.launch
    calls; the note of the gradient it computes; its build entry."""
    src = SRC_SM90.read_text()
    assert not re.search(r"\batomic\w*\s*\(", src)
    assert "expf(" in src and not re.search(r"__expf\s*\(", src)
    head = (build.CSRC / "sm90_wgmma.cuh").read_text()
    assert '#include "sm90_wgmma.cuh"' in src
    for needle in ("wgmma_ss_n64", "wgmma_rs_hd", "setmaxnreg", "tma_load",
                   "bulk_load", "__grid_constant__ Maps", "CUtensorMap q64"):
        assert needle in src, needle
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier"):
        assert needle in head, needle
    kernels_ = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                          r"(\w+)\s*\(", src)
    assert len(kernels_) == 4, kernels_
    assert all("flash_attention_bwd" in k for k in kernels_), kernels_
    for needle in ("flash_attention_bwd_sm90_launch",
                   "repro/models/attention.py:359", "_flash_bwd"):
        assert needle in src, needle
    assert build.SOURCES["flash_attention_bwd_sm90"] == \
        "flash_attention_bwd_sm90.cu"


def test_sm90_backward_plan_at_qwen3_widths():
    """The plan chip_smoke.py prints: at qwen3-14b's B 4 x S 512 (H 40, K
    8) one head group, the dK/dV role 4 x 8 x 4 = 128 blocks, key tile 0
    stepping over 5 heads x 8 query tiles, no longer than the mean work
    an SM; the dQ role 4 x 40 x 4 = 640 blocks of at most 4 key tiles.
    Every key visible: no tile is skipped, one group."""
    plan = fa.bwd_plan_sm90(4, 40, 8, 512, True, 132)
    assert plan["groups"] == 1
    assert plan["dkdv"]["blocks"] == 128 and plan["dq"]["blocks"] == 640
    assert plan["dkdv"]["longest_steps"] == 40
    assert plan["dkdv"]["mean_steps"] == 25
    assert plan["dq"]["longest_steps"] == 4
    assert plan["dq"]["mean_steps"] == 2.5
    assert plan["dkdv"]["tile"] == (128, 64) and plan["dq"]["tile"] == (
        128, 128)
    full = fa.bwd_plan_sm90(4, 20, 20, 1500, False, 132)
    assert full["groups"] == 1
    assert full["dkdv"]["blocks"] == 4 * 20 * 12
    assert full["dkdv"]["longest_steps"] == full["dkdv"]["mean_steps"] == 24
    assert full["dq"]["longest_steps"] == 12


def _train_layout(B=2, S=40, H=8, K=2, hd=16):
    """q, k, v as attend hands them to FlashAttention: the (B, S, heads,
    hd) bf16 projections of one matmul each, transposed."""
    rng = np.random.default_rng(5)
    return [torch.from_numpy(rng.normal(size=(B, S, n * hd)).astype(
        np.float32)).bfloat16().reshape(B, S, n, hd).transpose(1, 2)
        .requires_grad_(True) for n in (H, K, K)]


def test_tma_strides_take_the_training_layout(monkeypatch):
    """The five tensors the sm90 backward reads as training hands them
    in: q, k and v (the projections transposed), the forward's output
    (its empty_like of q) and the output gradient autograd brings back
    through attend's transpose and the output projection's reshape."""
    q, k, v = _train_layout()
    seen = {}
    real = fa.flash_attention_bwd

    def spy(q_, k_, v_, out, dout, lse, causal=True, q_offset=0):
        seen.update(q=q_, k=k_, v=v_, out=out, dout=dout)
        return real(q_, k_, v_, out, dout, lse, causal, q_offset)

    monkeypatch.setattr(fa, "flash_attention_bwd", spy)
    out = fa.FlashAttention.apply(q, k, v, True).transpose(1, 2)
    B, S, H, hd = out.shape
    w = torch.ones(H * hd, 8, dtype=torch.bfloat16)
    (out.reshape(B, S, H * hd) @ w).float().sum().backward()
    assert set(seen) == {"q", "k", "v", "out", "dout"}
    for name, t in seen.items():
        assert fa._tma_problem(t) is None, name
        assert fa.tma_strides(t)[1:] == ([hd, H * hd] if t.shape[1] == H
                                         else [hd, 2 * hd]), name
    assert seen["out"].stride() == seen["q"].stride()


def test_function_backward_makes_a_refused_dout_tma_legal(monkeypatch):
    """A dout whose layout a tensor map cannot describe (a 2-byte offset
    base, rows of 20 elements) reaches the sm90 route's backward as a
    contiguous copy of the same values; the cuda_core route's f32 dout
    keeps its layout."""
    seen = []

    def spy(q, k, v, out, dout, lse, causal=True, q_offset=0):
        seen.append(dout)
        return q, k, v

    monkeypatch.setattr(fa, "flash_attention_bwd", spy)

    class Ctx:
        causal = True
        q_offset = 0

    for dtype, hd in ((torch.bfloat16, 16), (torch.float32, 16)):
        q = torch.zeros(1, 2, 8, hd, dtype=dtype)
        Ctx.saved_tensors = (q, q, q, q, torch.zeros(1, 2, 8))
        for bad in (torch.arange(1 + 2 * 8 * hd, dtype=dtype)[1:].reshape(
                        1, 2, 8, hd),
                    torch.randn(1, 2, 8, 20).to(dtype)[..., :hd]):
            seen.clear()
            fa.FlashAttention.backward(Ctx, bad)
            (got,) = seen
            torch.testing.assert_close(got, bad, rtol=0, atol=0)
            if dtype == torch.bfloat16:
                assert fa._tma_problem(bad) is not None
                assert fa._tma_problem(got) is None
            else:
                assert got is bad


@pytest.mark.parametrize("shape,groups,longest", [
    ((1, 40, 8, 2048, True), 2, 3 * 32), ((1, 25, 5, 2176, True), 3, 2 * 34),
    ((4, 40, 8, 512, True), 1, 40), ((2, 8, 2, 300, True), 4, 5)])
def test_sm90_backward_plan_splits_long_key_tiles(shape, groups, longest):
    """Where a causal key tile 0 over all rep heads outlasts the launch's
    mean work an SM, the plan splits the heads into the fewest groups
    that bring it under (B 1 x S 2,048: 3 + 2 heads; hymba: 2 + 2 + 1),
    or into rep groups; the groups' steps add up to one group's."""
    plan = fa.bwd_plan_sm90(*shape, 132)
    assert plan["groups"] == groups
    assert plan["dkdv"]["longest_steps"] == longest
    one = fa.bwd_plan_sm90(*shape, 1)
    assert one["groups"] == 1
    B, H, K = shape[:3]
    assert plan["dkdv"]["blocks"] == one["dkdv"]["blocks"] * groups
    assert plan["dkdv"]["mean_steps"] * plan["dkdv"]["blocks"] == \
        one["dkdv"]["mean_steps"] * one["dkdv"]["blocks"]


def test_planted_faults_read_over_the_bf16_limit_at_the_sm90_shape():
    """chip_smoke.py reads its three planted backward faults against the
    sm90 route at BWD_FAULT_SHAPES["bf16"] (causal, ragged S 300, rep 4,
    hd 64) and needs each over the bf16 limit: here against the plain
    backward on the same bf16 inputs, which the route holds to ~4e-3."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    name = chip_smoke.BWD_FAULT_SHAPES["bf16"]
    (_, B, H, K, S, hd, causal, dtypes), = [
        x for x in chip_smoke.BWD_SHAPES if x[0] == name]
    assert "bf16" in dtypes and fa.route(torch.bfloat16, hd) == "sm90"
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(B, H, K, S, hd, seed=30))
    lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal,
                                   lse=True)[1]
    sound = fa.flash_attention_bwd_plain(q, k, v, do, lse, causal)
    tol = chip_smoke.BWD_TOL["bf16"]
    for fault in ("delta=0", "one-head", "no-diag"):
        bad = chip_smoke.planted_bwd(torch, q, k, v, do, lse, causal, fault)
        assert max(_rel(g.float(), w.float().numpy())
                   for g, w in zip(sound, bad)) > 3 * tol, fault


# ------------------------------------------------ the query-offset form

# a context-parallel step's chunks: Sk 64 keys in 4 chunks of Sq 16
# queries (GQA rep 4), each chunk at q_offset 0, Sq, 2 Sq and 3 Sq
OFF_SHAPE = (2, 8, 2, 16, 64, 16)      # B, H, K, Sq, Sk, hd
OFFSETS = (0, 16, 32, 48)
OFF_TOL = {"f32": 1e-5, "bf16": 3e-2}
# chip_smoke.py's phase 3c chunk: 512 queries of 2,048 at these offsets
OFFSETS_FULL = (0, 512, 1024, 1536)


def _chunk_inputs(seed=5):
    B, H, K, Sq, Sk, hd = OFF_SHAPE
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((B, H, Sk, hd), (B, K, Sk, hd), (B, K, Sk, hd), (B, H, Sk, hd))]


def _ref_chunk(q, k, v, do, off, dtype):
    """jax.vjp of the reference's sdpa_flash (its custom VJP, _flash_bwd)
    for the chunk's queries q (B, H, Sq, hd) at positions off .. off + Sq
    - 1 against every key, under the chunk's rows of its make_mask."""
    from repro.models.attention import make_mask as j_make_mask
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    rep = H // K
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    mask = jnp.broadcast_to(j_make_mask(jnp.arange(off, off + Sq),
                                        jnp.arange(Sk), causal=True),
                            (B, Sq, Sk))
    q5 = jnp.asarray(q, jd).reshape(B, K, rep, Sq, hd).transpose(
        0, 3, 1, 2, 4)
    kv = [jnp.asarray(x, jd).transpose(0, 2, 1, 3) for x in (k, v)]
    do5 = jnp.asarray(do, jd).reshape(B, K, rep, Sq, hd).transpose(
        0, 3, 1, 2, 4)
    _, vjp = jax.vjp(lambda a, b, c: sdpa_flash(a, b, c, mask, hd ** -0.5),
                     q5, *kv)
    dq5, dk, dv = (np.asarray(g, np.float32) for g in vjp(do5))
    dq = dq5.transpose(0, 2, 3, 1, 4).reshape(B, H, Sq, hd)
    return dq, dk.transpose(0, 2, 1, 3), dv.transpose(0, 2, 1, 3)


def _port_chunk(q, k, v, do, off, dtype):
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    tq, tk, tv, tdo = (torch.from_numpy(x).to(td) for x in (q, k, v, do))
    _, lse = fa.flash_attention(tq, tk, tv, True, lse=True, q_offset=off)
    return fa.flash_attention_bwd_plain(tq, tk, tv, tdo, lse, True, off)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("off", OFFSETS)
def test_offset_backward_matches_the_reference_chunk(off, dtype):
    """flash_attention_bwd_plain at q_offset against jax.vjp of the
    reference's sdpa_flash under the chunk's rows of make_mask, from the
    same numpy inputs (Sq != Sk, GQA); bf16 rounds as the reference's
    bf16 graph does, within 3e-2."""
    q, k, v, do = _chunk_inputs()
    Sq = OFF_SHAPE[3]
    qc, doc = q[:, :, off:off + Sq], do[:, :, off:off + Sq]
    got = _port_chunk(qc, k, v, doc, off, dtype)
    want = _ref_chunk(qc, k, v, doc, off, dtype)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g.float(), w) <= OFF_TOL[dtype], (name, _rel(g.float(),
                                                                 w))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_offset_chunks_sum_to_the_whole_sequence(dtype):
    """The four chunks' dk and dv summed (in f32, chunk order) and their
    dq concatenated equal the whole sequence's backward; every key past a
    chunk's last query gets exactly zero dk and dv."""
    q, k, v, do = _chunk_inputs()
    Sq = OFF_SHAPE[3]
    whole = _port_chunk(q, k, v, do, 0, dtype)
    dqs, dk, dv = [], 0.0, 0.0
    for off in OFFSETS:
        g = _port_chunk(q[:, :, off:off + Sq], k, v, do[:, :, off:off + Sq],
                        off, dtype)
        assert not g[1][:, :, off + Sq:].any() and \
            not g[2][:, :, off + Sq:].any()
        dqs.append(g[0])
        dk = dk + g[1].float()
        dv = dv + g[2].float()
    for g, w in zip((torch.cat(dqs, 2), dk, dv), whole):
        assert _rel(g.float(), w.float().numpy()) <= OFF_TOL[dtype]


@pytest.mark.parametrize("off", OFFSETS)
def test_function_at_an_offset_gives_the_plain_backward_bit_for_bit(off):
    """FlashAttention.apply(q, k, v, True, q_offset) driven by
    .backward(): on CPU tensors its forward is the plain forward at the
    offset, its gradients the plain backward's, bit for bit; a key past
    the chunk gets exact zeros."""
    q, k, v, do = _chunk_inputs(seed=8)
    Sq = OFF_SHAPE[3]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (
        q[:, :, off:off + Sq], k, v, do[:, :, off:off + Sq]))
    xs = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = fa.FlashAttention.apply(*xs, True, off)
    torch.testing.assert_close(out.detach(), fa.flash_attention_plain(
        tq, tk, tv, True, q_offset=off), rtol=0, atol=0)
    out.backward(tdo)
    _, lse = fa.flash_attention(tq, tk, tv, True, lse=True, q_offset=off)
    want = fa.flash_attention_bwd_plain(tq, tk, tv, tdo, lse, True, off)
    for x, w in zip(xs, want):
        torch.testing.assert_close(x.grad, w, rtol=0, atol=0)
    assert not xs[1].grad[:, :, off + Sq:].any()
    got = fa.flash_attention_bwd(tq, tk, tv, out.detach(), tdo, lse, True,
                                 off)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_attend_at_an_offset_differentiates_through_the_function():
    """Training's chunk (grad on) goes through FlashAttention at its
    offset and agrees with autograd through _sdpa under the chunk's rows
    of make_mask."""
    B, H, K, Sq, Sk, hd = OFF_SHAPE
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2) for x in
                   _chunk_inputs(seed=4))
    off = 32
    qc, doc = q[:, off:off + Sq], do[:, off:off + Sq]
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=128,
                      n_heads=H, n_kv_heads=K, d_ff=8, vocab=8, head_dim=hd,
                      dtype=torch.float32)
    qp = torch.arange(off, off + Sq).expand(B, Sq)
    kp = torch.arange(Sk).expand(B, Sk)
    grads = []
    for fn in (lambda a, b, c: attend(a, b, c, q_offset=off),
               lambda a, b, c: _sdpa(a, b, c, make_mask(qp, kp), cfg)):
        xs = [x.clone().requires_grad_(True) for x in (qc, k, v)]
        fn(*xs).backward(doc)
        grads.append([x.grad for x in xs])
    for got, want in zip(*grads):
        assert _rel(got, want.numpy()) <= TOL


def _encoder_chunks(S: int, n: int = 4):
    """models/model.py:_chunks -- S frames cut into n runs, ceil(S / n)
    long, the last shorter."""
    c = -(-S // n)
    return [(g * c, min((g + 1) * c, S)) for g in range(n)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Sk", [64, 62])
def test_noncausal_chunks_equal_the_whole_call(Sk, dtype):
    """An encoder layer over "model": each of 4 chunks of queries (Sq <
    Sk, ragged where 4 does not divide Sk) against every key, every key
    visible. The chunks' outputs concatenated equal the whole call's bit
    for bit in f32 (the same scores a row) and within 3e-2 in bf16; their
    dk and dv summed in f32 in chunk order and their dq concatenated
    equal the whole sequence's backward; each chunk's backward agrees
    with jax.vjp of the reference's sdpa_flash under an all-visible mask;
    FlashAttention runs it in training (``attend(..., causal=False)``)."""
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v, do = (torch.from_numpy(x[:, :, :Sk]).to(td)
                   for x in _chunk_inputs(seed=12))
    out_w, lse_w = fa.flash_attention(q, k, v, False, lse=True)
    whole = fa.flash_attention_bwd_plain(q, k, v, do, lse_w, False)
    outs, dqs, dk, dv = [], [], 0.0, 0.0
    for s, e in _encoder_chunks(Sk):
        qc, doc = q[:, :, s:e], do[:, :, s:e]
        out, lse = fa.flash_attention(qc, k, v, False, lse=True)
        outs.append(out)
        g = fa.flash_attention_bwd_plain(qc, k, v, doc, lse, False)
        B, H, Sq, hd = qc.shape
        mask = jnp.ones((B, Sq, Sk), bool)
        rep = H // k.shape[1]
        q5 = jnp.asarray(qc.float().numpy(), jnp.float32 if dtype == "f32"
                         else jnp.bfloat16)
        q5 = q5.reshape(B, -1, rep, Sq, hd).transpose(0, 3, 1, 2, 4)
        kv = [jnp.asarray(x.float().numpy(), q5.dtype).transpose(0, 2, 1, 3)
              for x in (k, v)]
        do5 = jnp.asarray(doc.float().numpy(), q5.dtype).reshape(
            B, -1, rep, Sq, hd).transpose(0, 3, 1, 2, 4)
        _, vjp = jax.vjp(lambda a, b_, c: sdpa_flash(a, b_, c, mask,
                                                     hd ** -0.5), q5, *kv)
        rdq, rdk, rdv = (np.asarray(x, np.float32) for x in vjp(do5))
        for got, want in zip(g, (rdq.transpose(0, 2, 3, 1, 4).reshape(
                B, H, Sq, hd), rdk.transpose(0, 2, 1, 3),
                rdv.transpose(0, 2, 1, 3))):
            assert _rel(got.float(), want) <= OFF_TOL[dtype]
        dqs.append(g[0])
        dk = dk + g[1].float()
        dv = dv + g[2].float()
    cat = torch.cat(outs, 2)
    if dtype == "f32":
        assert torch.equal(cat, out_w)
    assert _rel(cat.float(), out_w.float().numpy()) <= OFF_TOL[dtype]
    for g, w in zip((torch.cat(dqs, 2), dk, dv), whole):
        assert _rel(g.float(), w.float().numpy()) <= OFF_TOL[dtype]
    xs = [x.float().clone().requires_grad_(True) for x in
          (q[:, :, :16], k, v)]
    attend(*(x.transpose(1, 2) for x in xs), causal=False).transpose(
        1, 2).backward(do[:, :, :16].float())
    _, lse = fa.flash_attention(*(x.detach() for x in xs), False, lse=True)
    for x, w in zip(xs, fa.flash_attention_bwd_plain(
            *(x.detach() for x in xs), do[:, :, :16].float(), lse, False)):
        torch.testing.assert_close(x.grad, w, rtol=0, atol=0)


@pytest.mark.parametrize("off", OFFSETS_FULL)
def test_backward_flops_and_plan_count_a_chunks_tiles(off):
    """kernel_bwd_flops and bwd_plan_sm90 at (Sq, Sk, q_offset): the
    whole sequence's tiles split over its chunks (the causal diagonal
    tiles of every chunk at a 128-aligned offset are the whole's), a key
    tile past the chunk's last query stepping over none, a key tile up to
    the offset over every query tile."""
    B, H, K, Sq, Sk, hd = 1, 40, 8, 512, 2048, 128
    for dt in (torch.bfloat16, torch.float32):
        whole = fa.kernel_bwd_flops(B, H, Sk, hd, dt, True)
        parts = [fa.kernel_bwd_flops(B, H, Sq, hd, dt, True, Sk=Sk,
                                     q_offset=o) for o in OFFSETS_FULL]
        assert sum(parts) == whole
        assert fa.kernel_bwd_flops(B, H, Sq, hd, dt, True, Sk=Sk,
                                   q_offset=off) == parts[off // Sq]
        assert fa.kernel_bwd_flops(B, H, Sq, hd, dt, False, Sk=Sk,
                                   q_offset=off) > parts[off // Sq] \
            or off == Sk - Sq
    plan = fa.bwd_plan_sm90(B, H, K, Sq, True, 132, Sk, off)
    kv_tiles = -(-Sk // 128)
    assert plan["dkdv"]["blocks"] == B * K * plan["groups"] * kv_tiles
    assert plan["dq"]["blocks"] == B * H * (Sq // 128)
    assert plan["dq"]["longest_steps"] == (off + Sq) // 128
    assert fa.bwd_plan_sm90(1, 40, 8, 2048, True, 132) == fa.bwd_plan_sm90(
        1, 40, 8, 2048, True, 132, 2048, 0)


def test_backward_sources_take_the_offset():
    """Both routes' C entry points take (Sq, Sk, q_off) and the wrappers
    pass them: a chunk's dK/dV kernel starts at the query tile of k0 -
    q_off, its dQ kernel's causal key limit moves by q_off."""
    for src in (SRC.read_text(), SRC_SM90.read_text()):
        assert re.search(r"int Sq, int Sk, int q_off", src)
        assert "max(k0 - q_off, 0)" in src
        assert "q_off + q0" in src
    assert len(fa._BWD_ARGTYPES) == 10 + 9 + 2
    assert len(fa._BWD_SM90_ARGTYPES) == 11 + 9 + 2
