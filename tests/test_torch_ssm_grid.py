"""The SSD over a sequence cut into chunks, one a model index, with the
state handed across them (models/model.py:``_cp_ssm``, the
context-parallel prefill's and train step's mixer of mamba2 and hymba),
against the reference's whole-sequence ``repro.models.ssm.ssd_forward``
on the same seeded inputs, in f32 at smoke width: the output, the final
state and conv rows within 1e-5 relative L2, and the gradient of a
seeded weighting of both with respect to the input and every SSM
parameter against ``jax.grad`` of the same within 1e-5. The cuts: even
(off the ``ssm_chunk`` grid), on the grid, uneven, chunks of 1 and 2
tokens (the conv's rows before a chunk span several earlier chunks),
2 tokens on each of 8, an empty last chunk, and a chunk spanning
several SSD chunks.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

TOL = 1e-5
B = 2
# (name, arch, S, bounds)
CUTS = (
    ("even", "mamba2-130m", 40, ((0, 10), (10, 20), (20, 30), (30, 40))),
    ("grid", "mamba2-130m", 64, ((0, 16), (16, 32), (32, 48), (48, 64))),
    ("uneven", "mamba2-130m", 40, ((0, 13), (13, 29), (29, 40))),
    ("short", "mamba2-130m", 40, ((0, 1), (1, 3), (3, 5), (5, 40))),
    ("twos", "mamba2-130m", 16, tuple((2 * g, 2 * g + 2) for g in range(8))),
    ("empty_last", "mamba2-130m", 9, ((0, 3), (3, 6), (6, 9), (9, 9))),
    ("long_span", "hymba-1.5b", 48, ((0, 5), (5, 48))),
)


def _cfg(arch, dtype):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)


def _inputs(cfg, S):
    """Seeded f32 numpy inputs: x (B, S, D), the SSM's parameters at the
    reference's shapes, and the weights of the output and final state in
    the scalar whose gradient is compared."""
    rng = np.random.default_rng(S)
    D, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    E = 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + H
    f = np.float32
    p = {"in_proj": rng.standard_normal((D, E)) * D ** -0.5,
         "conv_w": rng.standard_normal((cfg.conv_dim, cfg.ssm_conv)) * 0.5,
         "conv_b": rng.standard_normal(cfg.conv_dim) * 0.1,
         "A_log": np.log(np.arange(1, H + 1)),
         "D_skip": 1 + 0.1 * rng.standard_normal(H),
         "dt_bias": rng.uniform(-4, -2, H),
         "norm_scale": 1 + 0.1 * rng.standard_normal(di),
         "out_proj": rng.standard_normal((di, D)) * di ** -0.5}
    p = {k: np.asarray(v, f) for k, v in p.items()}
    x = rng.standard_normal((B, S, D)).astype(f)
    w_y = rng.standard_normal((B, S, D)).astype(f)
    w_s = rng.standard_normal((B, H, cfg.ssm_state,
                               cfg.ssm_headdim)).astype(f)
    return x, p, w_y, w_s


@functools.lru_cache(maxsize=None)
def _reference(arch, S):
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import ssd_forward
    cfg = _cfg(arch, jnp.float32)
    x, p, w_y, w_s = (jax.tree.map(jnp.asarray, t)
                      for t in _inputs(cfg, S))

    def loss(x, p):
        y, cache = ssd_forward(x, p, cfg)
        return jnp.sum(y * w_y) + jnp.sum(cache["state"] * w_s), (y, cache)
    (_, (y, cache)), (gx, gp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(x, p)
    return np.asarray(y), {k: np.asarray(v) for k, v in cache.items()}, \
        np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name,arch,S,bounds", CUTS,
                         ids=[c[0] for c in CUTS])
def test_chunked_ssd_hands_its_state_on_as_the_reference(name, arch, S,
                                                         bounds):
    import torch
    from repro_torch.models.model import _cp_ssm
    torch.manual_seed(0)
    want_y, want_cache, want_gx, want_gp = _reference(arch, S)
    cfg = _cfg(arch, torch.float32)
    x, p, w_y, w_s = _inputs(cfg, S)
    x = torch.from_numpy(x).requires_grad_()
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    lp = types.SimpleNamespace(ssm=types.SimpleNamespace(**params))
    n = len(bounds)
    row = types.SimpleNamespace(devices=(torch.device("cpu"),) * n, tp=n)
    outs, cache = _cp_ssm(row, [lp] * n, [x[:, s:e] for s, e in bounds],
                          cfg, cache=True)
    y = torch.cat(outs, 1)
    assert tuple(y.shape) == want_y.shape
    assert _rel(y.detach(), want_y) <= TOL
    for g in range(n):
        assert _rel(cache[g]["state"].detach(), want_cache["state"]) <= TOL
        assert _rel(cache[g]["conv"].detach(), want_cache["conv"]) <= TOL
    loss = (y * torch.from_numpy(w_y)).sum() \
        + (cache[-1]["state"] * torch.from_numpy(w_s)).sum()
    loss.backward()
    assert _rel(x.grad, want_gx) <= TOL
    bad = {k: _rel(t.grad, want_gp[k]) for k, t in params.items()
           if _rel(t.grad, want_gp[k]) > TOL}
    assert not bad, bad


def test_an_unsplit_sequence_is_the_whole_ssd_bit_for_bit():
    """One chunk holding the whole sequence: ``_cp_ssm`` is
    ``ssd_forward`` bit for bit (the same local pass, no state handed
    in)."""
    import torch
    from repro_torch.models.model import _cp_ssm
    from repro_torch.models.ssm import ssd_forward
    cfg = _cfg("mamba2-130m", torch.float32)
    x, p, _, _ = _inputs(cfg, 40)
    x = torch.from_numpy(x)
    lp = types.SimpleNamespace(ssm=types.SimpleNamespace(
        **{k: torch.from_numpy(v) for k, v in p.items()}))
    row = types.SimpleNamespace(devices=(torch.device("cpu"),), tp=1)
    with torch.no_grad():
        (got,), (cache,) = _cp_ssm(row, [lp], [x], cfg, cache=True)
        want, want_cache = ssd_forward(x, lp.ssm, cfg)
    assert torch.equal(got, want)
    assert torch.equal(cache["state"], want_cache["state"])
    assert torch.equal(cache["conv"], want_cache["conv"])
