"""Loss and gradients of the port's other LM families against the JAX
reference on the CPU, at smoke size in f32: olmoe-1b-7b (MoE), mamba2-130m
(SSM), hymba-1.5b (hybrid: sliding windows, meta tokens, SSM beside
attention), whisper-large-v3 (encoder-decoder, with seeded frame
embeddings as ``enc_input``) and qwen2-vl-72b (VLM, (B, S, 3) M-RoPE
positions: a text prompt, whose t stream rises and so takes the flash
function, and a prompt around an image, whose patches share one t and
take _sdpa). The reference's own seeded weights are carried over with
convert.train_state_from_numpy; the same numpy batch goes through
jax.value_and_grad(repro.models.model.loss_fn) and the port's loss_fn +
backward (each layer recomputed, attention without a window through the
flash function's backward).

Tolerances: the loss within 1e-5 relative, every gradient leaf within
1e-4 relative L2 (summation order; leaves a family never reads, such as
mamba2's ln2, are zero in both).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as j_model
from repro.train import train_step as j_ts
from repro_torch.convert import (_stacked, model_config_from_reference_dict,
                                 train_state_from_numpy)
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model as t_model

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
B, S = 2, 40        # past hymba's smoke window (16) and meta tokens (8)
CASES = {"olmoe-1b-7b": "text", "mamba2-130m": "text", "hymba-1.5b": "text",
         "whisper-large-v3": "text", "qwen2-vl-72b": "text",
         "qwen2-vl-72b image": "image"}

torch.set_num_threads(1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.abs(got).max(initial=0.0))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree, np.float32)


def _positions(layout):
    """(B, S, 3) positions: arange on all three streams (text), or 8 text
    tokens, a 4 x 4 patch grid at one t, then text from t + 1 on."""
    if layout == "text":
        return np.broadcast_to(np.arange(S, dtype=np.int32)[None, :, None],
                               (B, S, 3)).copy()
    text, side = 8, 4
    pos = np.zeros((S, 3), np.int32)
    pos[:text] = np.arange(text)[:, None]
    g = np.arange(side * side)
    pos[text:text + side * side] = np.stack(
        [np.full_like(g, text), g // side, g % side], -1)
    rest = S - text - side * side
    pos[text + side * side:] = (text + side + np.arange(rest))[:, None]
    return np.broadcast_to(pos[None], (B, S, 3)).copy()


@functools.lru_cache(maxsize=None)
def _run(case):
    arch, layout = case.split()[0], CASES[case]
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                               dtype=jnp.float32)
    cfg = model_config_from_reference_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    batch["labels"][1, -4:] = -100
    if jcfg.encoder_layers:
        batch["enc_input"] = rng.standard_normal(
            (B, jcfg.encoder_ctx, jcfg.d_model), dtype=np.float32)
    if jcfg.mrope:
        batch["positions"] = _positions(layout)
    jstate = jax.jit(j_ts.init_train_state, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    loss_j, g_j = jax.jit(jax.value_and_grad(j_model.loss_fn),
                          static_argnums=2)(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()},
        jcfg)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   "cpu")
    before = fa.FlashAttention.backward
    calls = []

    def counting(ctx, dout):
        calls.append(dout.shape)
        return before(ctx, dout)

    fa.FlashAttention.backward = staticmethod(counting)
    try:
        loss_t = t_model.loss_fn(state["params"], batch, cfg)
        loss_t.backward()
    finally:
        fa.FlashAttention.backward = staticmethod(before)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)
                 ).numpy() for n, p in state["params"].named_parameters()}
    return (float(loss_j), dict(_leaves(g_j)), float(loss_t.detach()),
            dict(_leaves(_stacked(grads))), len(calls), cfg)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_reference(case):
    loss_j, _, loss_t, *_ = _run(case)
    assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j), (loss_t, loss_j)


@pytest.mark.parametrize("case", list(CASES))
def test_every_gradient_leaf_matches_reference(case):
    _, g_j, _, g_t, *_ = _run(case)
    assert sorted(g_t) == sorted(g_j)
    worst = {k: _rel(g_t[k], g_j[k]) for k in g_j}
    bad = {k: r for k, r in worst.items() if r > GRAD_TOL}
    assert not bad, bad


@pytest.mark.parametrize("case", list(CASES))
def test_flash_backward_runs_where_attention_takes_flash(case):
    """The flash function's backward runs once per layer whose attention
    takes the flash kernel: every olmoe layer, none of mamba2's, hymba's
    global layers, whisper's encoder and decoder layers, qwen2-vl's text
    prompt but not its image prompt."""
    *_, calls, cfg = _run(case)
    if not cfg.has_attention or CASES[case] == "image":
        want = 0
    else:
        want = sum(1 for w in t_model.layer_windows(cfg) if not w) \
            + cfg.encoder_layers
    assert calls == want > 0 or calls == want == 0
