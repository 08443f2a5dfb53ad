"""The port's LM serving path, dense family (repro_torch.models,
repro_torch.serve.engine), against the JAX reference on the CPU: the
same seeded weights (the reference's init_params, carried over with
convert.lm_params_from_numpy) and the same numpy prompts through both.

Tolerances:
  * f32: layers 1e-5 (XLA's and PyTorch's CPU matmuls, rsqrt, cos and
    sin differ in the last bits); logits and caches 1e-4 after two
    layers; greedy tokens identical.
  * bf16: 3e-2 on logits of magnitude ~0.5 (the reference's flash tests'
    bf16 tolerance; the two frameworks round the bf16 activations at
    other places -- XLA per op, PyTorch once per fused op -- and prefill's
    flash route keeps the reference oracle's bf16 scaling), the same on
    the caches (the second layer's keys and values come from activations
    that already differ by bf16 roundings), one bf16 ulp relative on
    norms, rotations and attention of the same inputs. Greedy tokens are
    compared only up to the first step where the reference's own top-2
    margin is within that tolerance: with random smoke weights bf16
    already changes the reference's tokens against f32 at near-ties.
"""
import dataclasses
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import model as j_model
from repro.serve.engine import generate as j_generate
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import (lm_params_from_numpy,
                                 model_config_from_reference_dict)
from repro_torch import kernels
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.serve.engine import generate

DENSE = ("qwen3-14b", "phi3-medium-14b", "internlm2-20b", "command-r-35b")
J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOGIT_TOL = {"f32": 1e-4, "bf16": 3e-2}
BF16_ULP = 2.0 ** -8            # relative spacing of bf16 at worst


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _pair(arch, dt, seed=0):
    """(reference cfg, reference params, port cfg, port params) at the
    arch's SMOKE size."""
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                               dtype=J_DT[dt])
    jp = j_model.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = model_config_from_reference_dict(dataclasses.asdict(jcfg))
    leaves = jax.tree.map(np.asarray, jp)
    return jcfg, jp, cfg, lm_params_from_numpy(leaves, cfg, device="cpu")


@pytest.fixture(scope="module", params=["f32", "bf16"])
def qwen(request):
    return (request.param,) + _pair("qwen3-14b", request.param)


def _prompt(B=3, S=16, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


# ------------------------------------------------------------ layers

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_matches_reference(dt):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    s = rng.uniform(0.5, 1.5, size=(64,)).astype(np.float32)
    want = j_layers.rmsnorm(jnp.asarray(x, J_DT[dt]),
                            jnp.asarray(s, J_DT[dt]), 1e-5)
    got = t_layers.rmsnorm(torch.from_numpy(x).to(T_DT[dt]),
                           torch.from_numpy(s).to(T_DT[dt]), 1e-5)
    assert got.dtype == T_DT[dt]
    tol = 1e-6 if dt == "f32" else BF16_ULP
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=1e-6)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(dt, theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 33, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(33), np.arange(100, 133)]).astype(np.int32)
    want = j_layers.apply_rope(jnp.asarray(x, J_DT[dt]), jnp.asarray(pos),
                               theta)
    got = t_layers.apply_rope(torch.from_numpy(x).to(T_DT[dt]),
                              torch.from_numpy(pos), theta)
    tol = 1e-5 if dt == "f32" else BF16_ULP
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        t_layers.rope_freqs(16, theta).numpy(),
        np.asarray(j_layers.rope_freqs(16, theta)), rtol=1e-6)


def test_project_qkv_and_sdpa_match_reference(qwen):
    dt, jcfg, jp, cfg, p = qwen
    tol = 1e-5 if dt == "f32" else LOGIT_TOL[dt]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    jlp = jax.tree.map(lambda t: t[0], jp["layers"]["attn"])
    jq, jk, jv = j_attn._project_qkv(jnp.asarray(x, J_DT[dt]), jlp, jcfg,
                                     jnp.asarray(pos))
    q, k, v = t_attn._project_qkv(torch.from_numpy(x).to(T_DT[dt]),
                                  p.layers[0].attn, cfg,
                                  torch.from_numpy(pos))
    for got, want in ((q, jq), (k, jk), (v, jv)):
        assert got.shape == want.shape
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    # _sdpa on the same q, k, v (the reference's), prefill- and
    # decode-shaped masks
    tq, tk, tv = (torch.tensor(_f32(a)).to(T_DT[dt])
                  for a in (jq, jk, jv))
    masks = [(j_attn.make_mask(jnp.asarray(pos), jnp.asarray(pos),
                               causal=True),
              t_attn.make_mask(torch.from_numpy(pos),
                               torch.from_numpy(pos)), slice(None)),
             (j_attn.make_mask(jnp.asarray(pos[:, 7:8]),
                               jnp.arange(12)[None], causal=True),
              t_attn.make_mask(torch.from_numpy(pos[:, 7:8]),
                               torch.arange(12)[None]),
              slice(7, 8))]
    for jm, tm, rows in masks:
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        want = j_attn._sdpa(jq[:, rows], jk, jv, jm, jcfg)
        got = t_attn._sdpa(tq[:, rows], tk, tv, tm, cfg)
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   rtol=1e-5 if dt == "f32" else BF16_ULP,
                                   atol=1e-5 if dt == "f32" else BF16_ULP)


def test_embed_scale_rounds_like_the_reference():
    """bf16 embeddings times sqrt(5120): the reference rounds the scalar
    to bf16 first (71.5), so 3.0 becomes 214.0; a Python float in
    PyTorch multiplies in f32 and gives 215.0."""
    cfg = get_config("qwen3-14b")
    jcfg = j_get_config("qwen3-14b")
    table = np.zeros((4, cfg.d_model), np.float32)
    table[1, :3] = (3.0, -3.0, 0.5)
    tokens = np.array([[1, 0]], np.int32)
    want = j_model.embed_tokens({"embed": jnp.asarray(table, jnp.bfloat16)},
                                jnp.asarray(tokens), jcfg)
    params = types.SimpleNamespace(
        embed=torch.from_numpy(table).to(torch.bfloat16))
    got = t_model.embed_tokens(params, torch.from_numpy(tokens).long(), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))
    assert float(got[0, 0, 0]) == 214.0 and float(got[0, 0, 1]) == -214.0
    naive = params.embed[1, 0] * cfg.d_model ** 0.5
    assert float(naive) == 215.0


# -------------------------------------------------------- the model

def test_lm_params_from_numpy_carries_every_leaf(qwen):
    dt, jcfg, jp, cfg, p = qwen
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert sum(t.numel() for t in p.parameters()) == n_ref \
        == cfg.param_count()
    assert all(t.dtype == T_DT[dt] and not t.requires_grad
               for t in p.parameters())
    np.testing.assert_array_equal(
        _f32(p.layers[1].mlp.w_down), _f32(jp["layers"]["mlp"]["w_down"][1]))
    np.testing.assert_array_equal(_f32(p.lm_head), _f32(jp["lm_head"]))


def test_prefill_logits_and_cache_match_reference(qwen):
    dt, jcfg, jp, cfg, p = qwen
    prompt = _prompt()
    jl, jc = j_model.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                             max_len=24)
    kernels.reset_launches()
    tl, tc = t_model.prefill(p, {"tokens": torch.from_numpy(prompt)}, cfg,
                             max_len=24)
    assert tl.shape == jl.shape == (3, 1, cfg.vocab)
    assert tc["k"].shape == jc["k"].shape and tc["idx"] == int(jc["idx"])
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0,
                               atol=LOGIT_TOL[dt])
    kv_tol = LOGIT_TOL[dt]
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(tc[key]), _f32(jc[key]),
                                   rtol=kv_tol, atol=kv_tol)


def test_decode_step_matches_reference(qwen):
    dt, jcfg, jp, cfg, p = qwen
    prompt = _prompt(seed=3)
    jl, jc = j_model.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                             max_len=20)
    tl, tc = t_model.prefill(p, {"tokens": torch.from_numpy(prompt)}, cfg,
                             max_len=20)
    tok = np.argmax(_f32(jl)[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(2):
        jl, jc = j_model.decode_step(jp, jnp.asarray(tok), jc, jcfg)
        tl, tc = t_model.decode_step(p, torch.from_numpy(tok).long(), tc,
                                     cfg)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0,
                                   atol=LOGIT_TOL[dt])
        assert tc["idx"] == int(jc["idx"])
        tok = (tok + 7) % cfg.vocab
    np.testing.assert_allclose(_f32(tc["k"]), _f32(jc["k"]),
                               rtol=LOGIT_TOL[dt], atol=LOGIT_TOL[dt])


def test_forward_matches_reference(qwen):
    dt, jcfg, jp, cfg, p = qwen
    prompt = _prompt(B=2, S=10, seed=4)
    want = j_model.forward(jp, {"tokens": jnp.asarray(prompt)}, jcfg)
    got = p(torch.from_numpy(prompt))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=LOGIT_TOL[dt])


def test_greedy_generate_matches_reference(qwen):
    """f32: every token equal. bf16: equal up to the first step where the
    reference's own top-2 margin is within the logit tolerance (read from
    the reference's forward over its own output)."""
    dt, jcfg, jp, cfg, p = qwen
    prompt, S, n = _prompt(), 16, 8
    want = np.asarray(j_generate(jp, jcfg, jnp.asarray(prompt),
                                 max_new_tokens=n))
    got = generate(p, cfg, prompt, max_new_tokens=n)
    assert got.shape == want.shape == (3, S + n) and got.device.type == "cpu"
    np.testing.assert_array_equal(got[:, :S].numpy(), prompt)
    if dt == "f32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    logits = _f32(j_model.forward(jp, {"tokens": jnp.asarray(want[:, :-1])},
                                  jcfg))[:, S - 1:]
    top2 = np.sort(logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > LOGIT_TOL[dt]
    compared = 0
    for b in range(3):
        t = n if clear[b].all() else int(np.argmin(clear[b]))
        np.testing.assert_array_equal(got[b, S:S + t].numpy(),
                                      want[b, S:S + t])
        compared += t
    assert compared >= 3


def test_prefill_decode_consistency_over_40_layers_bf16():
    """The CPU twin of chip_smoke.py's full-width check: the last logits
    of prefill(prompt) against prefill(prompt[:, :-1]) + decode_step, in
    bf16 over qwen3's 40 layers at width 512. The two paths round other
    bf16 intermediates (the flash route's plain version scales scores in
    bf16, _sdpa in f32; M = 1 against M = 128 matmuls) and the residual
    stream compounds them layer by layer: 5e-2 relative L2, the card's
    bound."""
    cfg = dataclasses.replace(get_config("qwen3-14b"), d_model=512,
                              n_heads=4, n_kv_heads=2, d_ff=1024,
                              vocab=4096)
    p = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, cfg.vocab, (2, 128),
                        generator=torch.Generator().manual_seed(1))
    full, _ = t_model.prefill(p, {"tokens": tok}, cfg, 128)
    _, cache = t_model.prefill(p, {"tokens": tok[:, :-1]}, cfg, 128)
    step, _ = t_model.decode_step(p, tok[:, -1:], cache, cfg)
    a, b = full[:, -1].float(), step[:, -1].float()
    assert float((a - b).norm() / a.norm()) <= 5e-2
    assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_decode_consistency_catches_planted_faults():
    """chip_smoke.py's f32 check at full width, on the CPU twin (40
    layers at width 512): prefill and prefill[:-1] + decode_step agree to
    summation order, under the 1e-3 limit, and a decode with RoPE one
    position late or with its key and value written one slot early lands
    above it."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = dataclasses.replace(get_config("qwen3-14b"), d_model=512,
                              n_heads=4, n_kv_heads=2, d_ff=1024,
                              vocab=4096, dtype=torch.float32)
    p = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, cfg.vocab, (2, 128),
                        generator=torch.Generator().manual_seed(1))
    _, _, rel = chip_smoke.decode_consistency(torch, p, cfg, tok)
    assert set(rel) == {"sound", "pos+1", "kv@idx-1"}
    assert rel["sound"] <= chip_smoke.CONSIST_TOL_F32
    assert min(rel["pos+1"], rel["kv@idx-1"]) > chip_smoke.CONSIST_TOL_F32


def test_dense_forward_and_prefill_take_arange_positions_only():
    """The dense family needs no positions: arange ones, given as a
    tensor or numpy, give the logits of none (the flash route either
    way); M-RoPE's (B, S, 3) shape is refused for it only where it is
    not (B, S) or (B, S, 3)."""
    cfg = dataclasses.replace(get_config("qwen3-14b", smoke=True),
                              dtype=torch.float32)
    p = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    base = {"tokens": tokens}
    want_f = t_model.forward(p, base, cfg)
    want_p = t_model.prefill(p, base, cfg, max_len=8)[0]
    for pos in (torch.arange(6).expand(2, 6), np.tile(np.arange(6), (2, 1))):
        batch = {"tokens": tokens, "positions": pos}
        assert torch.equal(t_model.forward(p, batch, cfg), want_f)
        assert torch.equal(t_model.prefill(p, batch, cfg, max_len=8)[0],
                           want_p)
    with pytest.raises(ValueError, match="positions of shape"):
        t_model.prefill(p, {"tokens": tokens,
                            "positions": torch.arange(5)[None]}, cfg, 8)


def test_generate_greedy_deterministic_and_sampling_in_range():
    cfg = get_config("qwen3-14b", smoke=True)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    p = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    a = generate(p, cfg, prompt, max_new_tokens=6)
    b = generate(p, cfg, prompt.numpy(), max_new_tokens=6)
    assert a.shape == (2, 14) and torch.equal(a, b)
    s1 = generate(p, cfg, prompt, 6, temperature=1.0,
                  generator=torch.Generator().manual_seed(7))
    s2 = generate(p, cfg, prompt, 6, temperature=1.0,
                  generator=torch.Generator().manual_seed(7))
    assert torch.equal(s1, s2) and torch.equal(s1[:, :8], prompt)
    assert bool(((s1 >= 0) & (s1 < cfg.vocab)).all())


def test_init_params_distributions():
    """The reference's distributions: std fan_in^-0.5 for projections,
    0.02 for embed and lm_head, ones for norms."""
    cfg = dataclasses.replace(get_config("qwen3-14b", smoke=True),
                              d_model=256, d_ff=512, vocab=2048)
    p = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert p.embed.dtype == torch.bfloat16
    for t, std in ((p.embed, 0.02), (p.lm_head, 0.02),
                   (p.layers[0].attn.wq, 256 ** -0.5),
                   (p.layers[1].mlp.w_down, 512 ** -0.5)):
        assert abs(float(t.float().std()) / std - 1) < 0.02
    assert bool((p.layers[0].attn.q_norm == 1).all())
    assert bool((p.final_norm.scale == 1).all())


# ------------------------------------------------- configs and seams

@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_dense_configs_equal_the_reference(arch, smoke):
    ref = j_get_config(arch, smoke=smoke)
    got = get_config(arch, smoke=smoke)
    assert got == model_config_from_reference_dict(dataclasses.asdict(ref))
    assert got.dtype == torch.bfloat16
    assert got.param_count() == ref.param_count()
    assert (got.hd, got.has_attention, got.has_ssm, got.is_moe) == \
        (ref.hd, ref.has_attention, ref.has_ssm, ref.is_moe)


#: the encoder-decoder and VLM archs (tests/test_torch_lm_encdec_vlm.py
#: holds them to the reference)
LATER = ("qwen2-vl-72b", "whisper-large-v3")
#: the MoE, SSM and hybrid archs (tests/test_torch_lm_families*.py hold
#: them to the reference)
FAMILIES = sorted(set(ARCH_IDS) - set(DENSE) - set(LATER))


@pytest.mark.parametrize("arch", LATER)
def test_other_families_raise_naming_their_slice(arch):
    """The two families of the last LM serving slice build and run at
    smoke size: configs (full and smoke) equal to the reference's,
    init_params with param_count() parameters; whisper's greedy generate
    with enc_input deterministic and in range (without enc_input it
    raises naming it); qwen2-vl's prefill with (B, S, 3) positions and a
    decode step deterministic and in range, while generate, which takes
    no positions, raises naming them."""
    for smoke in (False, True):
        ref = j_get_config(arch, smoke=smoke)
        got = get_config(arch, smoke=smoke)
        assert got == model_config_from_reference_dict(
            dataclasses.asdict(ref))
        assert got.param_count() == ref.param_count()
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    p = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for t in p.parameters()) == cfg.param_count()
    prompt = torch.randint(0, cfg.vocab, (2, 30),
                           generator=torch.Generator().manual_seed(1))
    if cfg.encoder_layers:
        frames = torch.randn(2, cfg.encoder_ctx, cfg.d_model,
                             generator=torch.Generator().manual_seed(2))
        a = generate(p, cfg, prompt, max_new_tokens=5, enc_input=frames)
        assert a.shape == (2, 35) and torch.equal(a[:, :30], prompt)
        assert bool(((a >= 0) & (a < cfg.vocab)).all())
        assert torch.equal(a, generate(p, cfg, prompt, 5, enc_input=frames))
        with pytest.raises(ValueError, match="enc_input"):
            generate(p, cfg, prompt, max_new_tokens=5)
        return
    pos = torch.arange(30)[None, :, None].expand(2, 30, 3)
    runs = []
    for _ in range(2):
        logits, cache = t_model.prefill(p, {"tokens": prompt,
                                            "positions": pos}, cfg, 32)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        step, cache = t_model.decode_step(p, tok, cache, cfg)
        runs.append((tok, step))
    assert cache["idx"] == 31 and step.shape == (2, 1, cfg.vocab)
    assert bool(((tok >= 0) & (tok < cfg.vocab)).all())
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    with pytest.raises(ValueError, match=r"\(B, S, 3\) positions"):
        generate(p, cfg, prompt, max_new_tokens=5)


def test_vlm_generate_raises_naming_positions():
    """generate on an M-RoPE config raises ValueError (the reference's
    generate fails there with an IndexError): its positions go through
    prefill and decode_step."""
    cfg = dataclasses.replace(get_config("qwen2-vl-72b", smoke=True),
                              dtype=torch.float32)
    p = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="prefill") as err:
        generate(p, cfg, np.zeros((1, 4), np.int64), max_new_tokens=2)
    assert "positions" in str(err.value)


@pytest.mark.parametrize("arch", FAMILIES)
def test_moe_ssm_and_hybrid_families_build_and_run_at_smoke_size(arch):
    """get_config (full and smoke) equal to the reference's, init_params
    with param_count() parameters, and greedy generate at smoke size:
    tokens in range, the prompt kept, the same tokens on a rerun."""
    for smoke in (False, True):
        ref = j_get_config(arch, smoke=smoke)
        got = get_config(arch, smoke=smoke)
        assert got == model_config_from_reference_dict(
            dataclasses.asdict(ref))
        assert got.param_count() == ref.param_count()
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    p = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for t in p.parameters()) == cfg.param_count()
    prompt = torch.randint(0, cfg.vocab, (2, 30),
                           generator=torch.Generator().manual_seed(1))
    a = generate(p, cfg, prompt, max_new_tokens=5)
    assert a.shape == (2, 35) and torch.equal(a[:, :30], prompt)
    assert bool(((a >= 0) & (a < cfg.vocab)).all())
    assert torch.equal(a, generate(p, cfg, prompt, max_new_tokens=5))


def test_qwen3_full_width_is_what_the_card_holds():
    cfg = get_config("qwen3-14b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd) == (40, 5120, 40, 8, 128)
    assert 2 * cfg.param_count() < 30e9           # bf16 bytes, one card


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    """Without a GPU, anything but an explicit CPU request raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-14b", smoke=True)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_model.init_params(cfg, torch.Generator(), device)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm_params_from_numpy({}, cfg, device)
    p = t_model.init_params(cfg, torch.Generator(), "cpu")
    assert p.device.type == "cpu"
