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
    wrapper or the Function."""
    tree = ast.parse(inspect.getsource(fa))
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef)}
    for name in ("flash_attention_bwd", "backward", "forward"):
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
