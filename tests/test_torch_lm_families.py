"""The port's MoE, SSM and windowed-attention modules (repro_torch.models
moe, ssm, attention) against the JAX reference's, function by function
on the CPU: the same numpy-seeded inputs and the reference's own smoke
weights (carried over with convert.lm_params_from_numpy) through both,
the reference's functions called with ctx=None and compiled with XLA's
excess precision off (each bf16 op rounded as issued, as the port
computes).

Tolerances: test_torch_lm.py's LOGIT_TOL (f32 1e-4, bf16 3e-2) on
outputs and caches; routing (slots, token ids, dropped choices) and
masks exact; dispatched buffers exact (copies of the inputs).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import model as j_model
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro_torch.convert import (lm_params_from_numpy,
                                 model_config_from_reference_dict)
from repro_torch.models import attention as t_attn
from repro_torch.models import moe as t_moe
from repro_torch.models.model import F32_LEAVES
from repro_torch.models import ssm as t_ssm
from repro_torch.launch.mesh import make_host_mesh

#: the reference's ctx.banded on a one-device grid
_BANDED = t_moe.ShardingCtx(grid=make_host_mesh(device="cpu"),
                            dp_axes=("data",), banded=True)

J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOGIT_TOL = {"f32": 1e-4, "bf16": 3e-2}
DTS = ("f32", "bf16")

torch.set_num_threads(1)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's f32 smoke parameters (init_params, key 0)."""
    jcfg = j_get_config(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    return jax.jit(j_model.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _pair(arch, dt):
    """(reference cfg, its layer-0 params, port cfg, port layer 0) at the
    arch's smoke size. The reference's bf16 init is its f32 one cast
    (normal x std, then astype), the SSM's f32 leaves aside."""
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                               dtype=J_DT[dt])
    jp = jax.tree_util.tree_map_with_path(
        lambda path, t: t if path[-1].key in F32_LEAVES
        else t.astype(J_DT[dt]), _ref_params(arch))
    cfg = model_config_from_reference_dict(dataclasses.asdict(jcfg))
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                             device="cpu")
    return (jcfg, jax.tree.map(lambda t: t[0], jp["layers"]), cfg,
            p.layers[0])


def _jit(fn, **static):
    """The reference's ``fn``, its config and options ``static`` fixed,
    compiled with XLA's excess precision off: each bf16 op rounded as it
    is issued, as in the reference's op-by-op run and in the port
    (test_torch_lm_families_archs.py)."""
    f = jax.jit(functools.partial(fn, **static))

    def run(*args, **kw):
        return f.lower(*args, **kw).compile(compiler_options={
            "xla_allow_excess_precision": False})(*args, **kw)
    return run


def _x(shape, seed, dt, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    a *= scale
    return jnp.asarray(a, J_DT[dt]), torch.from_numpy(a).to(T_DT[dt])


def _close(got, want, dt, what=""):
    assert tuple(got.shape) == tuple(want.shape), what
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=LOGIT_TOL[dt],
                               atol=LOGIT_TOL[dt], err_msg=what)


# ---------------------------------------------------------------- MoE

def _gates(T, E, seed, ties=False):
    """(T, E) f32 probabilities; with ``ties``, each row's two largest
    are equal, so top-k must keep the lower expert first."""
    g = np.random.default_rng(seed).dirichlet(np.ones(E), T).astype(
        np.float32)
    if ties:
        top = np.argsort(-g, -1)[:, :2]
        rows = np.arange(T)
        g[rows, top[:, 1]] = g[rows, top[:, 0]]
    return g


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("arch,cf,ties", [
    ("olmoe-1b-7b", None, False), ("olmoe-1b-7b", 0.5, False),
    ("olmoe-1b-7b", None, True), ("llama4-scout-17b-a16e", 0.5, True)])
def test_route_matches_reference(arch, cf, ties, dt):
    """Equal slots, token ids, weights and dispatched buffers, with ties
    and with a capacity small enough to drop the latest tokens."""
    jcfg, _, cfg, _ = _pair(arch, dt)
    if cf:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    T = 48
    jx, tx = _x((T, cfg.d_model), 1, dt)
    g = _gates(T, cfg.n_experts, 2, ties)
    C = t_moe._capacity(T, cfg)
    assert C == j_moe._capacity(T, jcfg)
    want = _jit(j_moe._route, cfg=jcfg, capacity=C)(jx, jnp.asarray(g))
    got = t_moe._route(tx, torch.from_numpy(g), cfg, C)
    for name, a, b in zip(("buf", "tok_ids", "slot", "weight"), got, want):
        np.testing.assert_array_equal(_f32(a), _f32(b), err_msg=name)
    assert got[0].dtype == got[3].dtype == T_DT[dt]
    dropped = int((got[2] == C).sum())
    assert (dropped > 0) == (cf is not None)
    np.testing.assert_array_equal(
        t_moe._top_k(torch.from_numpy(g), cfg.top_k)[1].numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(g), cfg.top_k)[1]))


@pytest.mark.parametrize("dt", DTS)
def test_combine_matches_reference(dt):
    """k contributions a token, added in slot order, each add rounded in
    the dtype; dropped slots contribute zeros."""
    jcfg, _, cfg, _ = _pair("olmoe-1b-7b", dt)
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
    T, E, k, D = 40, cfg.n_experts, cfg.top_k, cfg.d_model
    C = t_moe._capacity(T, cfg)
    jx, tx = _x((T, D), 3, dt)
    g = _gates(T, E, 4)
    _, tok, slot, w = _jit(j_moe._route, cfg=jcfg, capacity=C)(
        jx, jnp.asarray(g))
    tok, slot = np.array(tok), np.array(slot)
    e_flat = np.array(jax.lax.top_k(jnp.asarray(g), k)[1]).reshape(-1)
    jo, to = _x((E, C, D), 5, dt, scale=3.0)
    want = _jit(j_moe._combine, T=T)(jo, tok, (jnp.asarray(e_flat), slot),
                                     w)
    np.testing.assert_array_equal(tok, np.repeat(np.arange(T), k))
    got = t_moe._combine(to, (torch.from_numpy(e_flat),
                              torch.from_numpy(slot)),
                         torch.from_numpy(np.array(w, np.float32)).to(
                             T_DT[dt]), T)
    assert int((slot == C).sum()) > 0
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("arch,cf", [
    ("olmoe-1b-7b", None), ("olmoe-1b-7b", 0.5),
    ("llama4-scout-17b-a16e", None), ("llama4-scout-17b-a16e", 0.5)])
def test_moe_ffn_matches_reference(arch, cf, dt):
    """moe_ffn (with llama4's shared expert) on (3, 16, D), at the smoke
    config's capacity and at one that drops tokens."""
    jcfg, jlp, cfg, lp = _pair(arch, dt)
    if cf:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jx, tx = _x((3, 16, cfg.d_model), 6, dt)
    with torch.inference_mode():
        got = t_moe.moe_ffn(tx, lp.moe, cfg)
    want = _jit(j_moe.moe_ffn, cfg=jcfg)(jx, jlp["moe"])
    assert got.dtype == T_DT[dt]
    _close(got, want, dt)


def test_capacity_matches_reference():
    for arch in ("olmoe-1b-7b", "llama4-scout-17b-a16e"):
        for full in (False, True):
            jcfg = j_get_config(arch, smoke=not full)
            cfg = model_config_from_reference_dict(dataclasses.asdict(jcfg))
            for T in (1, 4, 7, 2048, 2044, 8192):
                assert t_moe._capacity(T, cfg) == j_moe._capacity(T, jcfg)


# ---------------------------------------------------------------- SSM

@pytest.mark.parametrize("dt", DTS)
def test_causal_conv_matches_reference(dt):
    jcfg, jlp, cfg, lp = _pair("mamba2-130m", dt)
    jx, tx = _x((2, 21, cfg.conv_dim), 7, dt)
    want = _jit(j_ssm._causal_conv, k=cfg.ssm_conv)(
        jx, jlp["ssm"]["conv_w"], jlp["ssm"]["conv_b"])
    got = t_ssm._causal_conv(tx, lp.ssm.conv_w, lp.ssm.conv_b, cfg.ssm_conv)
    assert got.dtype == T_DT[dt]
    _close(got, want, dt)


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("arch,S", [("mamba2-130m", 10), ("mamba2-130m", 32),
                                    ("mamba2-130m", 40), ("hymba-1.5b", 40)])
def test_ssd_forward_and_decode_match_reference(arch, S, dt):
    """ssd_forward below, at and off a multiple of the chunk (16 at
    smoke size): output and cache, the state f32; then two ssd_decode
    steps from that cache."""
    jcfg, jlp, cfg, lp = _pair(arch, dt)
    jx, tx = _x((2, S, cfg.d_model), 8, dt)
    with torch.inference_mode():
        got, cache = t_ssm.ssd_forward(tx, lp.ssm, cfg)
    want, jcache = _jit(j_ssm.ssd_forward, cfg=jcfg)(jx, jlp["ssm"])
    _close(got, want, dt, "y")
    for key in ("state", "conv"):
        assert cache[key].dtype == torch.float32
        _close(cache[key], jcache[key], dt, key)
    for i in range(2):
        jt, tt = _x((2, 1, cfg.d_model), 9 + i, dt)
        with torch.inference_mode():
            got, cache = t_ssm.ssd_decode(tt, lp.ssm, cfg, cache)
        want, jcache = _jit(j_ssm.ssd_decode, cfg=jcfg)(jt, jlp["ssm"],
                                                        cache=jcache)
        _close(got, want, dt, f"decode {i}")
        for key in ("state", "conv"):
            _close(cache[key], jcache[key], dt, f"decode {i} {key}")


def test_ssd_chunk_padding_leaves_the_state_unchanged():
    """A sequence padded up to the chunk (dt = 0 on the padding) ends in
    the state of the unpadded recurrence, step by step."""
    _, _, cfg, lp = _pair("mamba2-130m", "f32")
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(1, 21, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        y, full = t_ssm.ssd_forward(x, lp.ssm, cfg)
        _, cache = t_ssm.ssd_forward(x[:, :4], lp.ssm, cfg)
        for s in range(4, 21):
            ys, cache = t_ssm.ssd_decode(x[:, s:s + 1], lp.ssm, cfg, cache)
    np.testing.assert_allclose(full["state"].numpy(), cache["state"].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y[:, -1:].numpy(), ys.numpy(), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------- attention

@pytest.mark.parametrize("window,n_meta", [(0, 0), (16, 0), (16, 8),
                                           (5, 3)])
def test_make_mask_matches_reference(window, n_meta):
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    want = j_attn.make_mask(jnp.asarray(pos), jnp.asarray(pos), causal=True,
                            window=window, n_meta=n_meta)
    got = t_attn.make_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                           window=window, n_meta=n_meta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = pos[:, 29:30]
    want = j_attn.make_mask(jnp.asarray(q), jnp.arange(48)[None],
                            causal=True, window=window, n_meta=n_meta)
    got = t_attn.make_mask(torch.from_numpy(q), torch.arange(48)[None],
                           window=window, n_meta=n_meta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("window,n_meta,banded", [
    (0, 0, False), (16, 0, False), (16, 8, False), (16, 8, True),
    (16, 0, True)])
def test_windowed_attention_matches_reference(window, n_meta, banded, dt):
    """Full-sequence attention at S 40 (past the smoke window 16 and 8
    meta tokens): the flash route without a window, the masked _sdpa or
    banded_core with one -- each against the reference's masked
    attention (its baseline for the banded form too)."""
    jcfg, jlp, cfg, lp = _pair("hymba-1.5b", dt)
    jx, tx = _x((2, 40, cfg.d_model), 12, dt)
    pos = jnp.broadcast_to(jnp.arange(40)[None], (2, 40))
    want = _jit(j_attn.attention, cfg=jcfg, window=window, n_meta=n_meta)(
        jx, jlp["attn"], positions=pos)
    with torch.inference_mode():
        got = t_attn.attention(tx, lp.attn, cfg, window=window,
                               n_meta=n_meta, ctx=_BANDED if banded else None)
    _close(got, want, dt)
    if banded:
        with torch.inference_mode():
            got = t_attn.banded_attention(tx, lp.attn, cfg, window=window,
                                          n_meta=n_meta)
        want = _jit(j_attn.banded_attention, cfg=jcfg, window=window,
                    n_meta=n_meta)(jx, jlp["attn"], positions=pos)
        _close(got, want, dt, "banded_attention")


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("S,window,n_meta", [(40, 16, 0), (40, 16, 8),
                                             (37, 16, 8), (23, 7, 3)])
def test_banded_core_matches_reference(S, window, n_meta, dt):
    """banded_core on the same projected q, k, v, S a multiple of the
    window or not, with and without meta tokens."""
    jcfg, _, cfg, _ = _pair("hymba-1.5b", dt)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    jq, tq = _x((2, S, H, hd), 13, dt)
    jk, tk = _x((2, S, K, hd), 14, dt)
    jv, tv = _x((2, S, K, hd), 15, dt)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    want = _jit(j_attn.banded_core, cfg=jcfg, window=window,
                n_meta=n_meta)(jq, jk, jv, jnp.asarray(pos))
    got = t_attn.banded_core(tq, tk, tv, torch.from_numpy(pos).long(), cfg,
                             window=window, n_meta=n_meta)
    assert got.dtype == T_DT[dt]
    _close(got, want, dt)


# (S, chunks): offsets off the window's 16-row blocks; chunks of 3 and 8
# rows; chunks whose band starts past the 8 meta keys (q_offset > 23)
CHUNK_CUTS = ((40, ((0, 13), (13, 29), (29, 40))),
              (64, ((0, 30), (30, 33), (33, 64))),
              (64, tuple((8 * g, 8 * g + 8) for g in range(8))))


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("banded", [True, False])
@pytest.mark.parametrize("S,bounds", CHUNK_CUTS,
                         ids=["thirds", "short", "eights"])
def test_window_chunks_read_their_band_as_the_whole_sequence(S, bounds,
                                                            banded, dt):
    """A context-parallel chunk's windowed attention (``attend_chunk``,
    window 16, 8 meta keys), its queries at their offset against the
    whole sequence's keys: ``banded_core``'s chunk form under
    ctx.banded, else ``_sdpa`` over the meta keys and the band. The
    chunks concatenated against the reference's ``banded_core`` on the
    whole sequence (LOGIT_TOL), against the port's whole-sequence form
    (``self_attend``, the row path's) within 1e-6 in f32 and 1e-2 in
    bf16, and in f32 the gradients of q, k and v through the chunks
    against the whole's within 1e-5."""
    jcfg, _, cfg, _ = _pair("hymba-1.5b", dt)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kw = dict(window=16, n_meta=8)
    ctx = _BANDED if banded else None
    jq, tq = _x((2, S, H, hd), 23, dt)
    jk, tk = _x((2, S, K, hd), 24, dt)
    jv, tv = _x((2, S, K, hd), 25, dt)
    pos = torch.arange(S).expand(2, S)
    want = _jit(j_attn.banded_core, cfg=jcfg, **kw)(
        jq, jk, jv, jnp.asarray(pos.numpy(), jnp.int32))
    grad = dt == "f32"
    q, k, v = (t.clone().requires_grad_(grad) for t in (tq, tk, tv))
    whole = t_attn.self_attend(q, k, v, cfg, pos, ctx=ctx, **kw)
    cq, ck, cv = (t.clone().requires_grad_(grad) for t in (tq, tk, tv))
    got = torch.cat([t_attn.attend_chunk(cq[:, s:e], ck, cv, cfg,
                                         pos[:, s:e], pos, s, ctx=ctx, **kw)
                     for s, e in bounds], 1)
    _close(got.detach(), want, dt)
    tol = 1e-6 if grad else 1e-2
    rel = (torch.linalg.vector_norm((got - whole).float())
           / torch.linalg.vector_norm(whole.float())).item()
    assert rel <= tol, rel
    if grad:
        w = torch.from_numpy(np.random.default_rng(26).normal(
            size=got.shape).astype(np.float32))
        (whole * w).sum().backward()
        (got * w).sum().backward()
        for a, b in ((cq, q), (ck, k), (cv, v)):
            rel = (torch.linalg.vector_norm(a.grad - b.grad)
                   / torch.linalg.vector_norm(b.grad)).item()
            assert rel <= 1e-5, rel


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("window,n_meta,windowed", [
    (0, 0, False), (16, 8, False), (16, 0, False), (16, 8, True),
    (16, 0, True)])
def test_attention_decode_matches_reference(window, n_meta, windowed, dt):
    """One token against a cache of 48 slots at idx 30 (0 past the
    window): attention_decode's masked read, and
    attention_decode_windowed's read of the live window and the meta
    prefix; output and the written cache."""
    jcfg, jlp, cfg, lp = _pair("hymba-1.5b", dt)
    K, hd = cfg.n_kv_heads, cfg.hd
    jx, tx = _x((2, 1, cfg.d_model), 16, dt)
    jk, tk = _x((2, 48, K, hd), 17, dt)
    jv, tv = _x((2, 48, K, hd), 18, dt)
    idx = 30
    pos = np.full((2, 1), idx, np.int32)
    jfn = j_attn.attention_decode_windowed if windowed \
        else j_attn.attention_decode
    tfn = t_attn.attention_decode_windowed if windowed \
        else t_attn.attention_decode
    want, jc = _jit(jfn, cfg=jcfg, window=window, n_meta=n_meta)(
        jx, jlp["attn"], cache={"k": jk, "v": jv, "idx": jnp.asarray(idx)},
        positions=jnp.asarray(pos))
    with torch.inference_mode():
        got, tc = tfn(tx, lp.attn, cfg, {"k": tk, "v": tv, "idx": idx},
                      torch.from_numpy(pos), window=window, n_meta=n_meta)
    _close(got, want, dt)
    assert tc["idx"] == int(jc["idx"]) == idx + 1
    for key in ("k", "v"):
        _close(tc[key], jc[key], dt, key)
