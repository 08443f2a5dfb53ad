"""The port's LM serving path for the MoE, SSM and hybrid families
(olmoe-1b-7b, llama4-scout-17b-a16e, mamba2-130m, hymba-1.5b) against
the JAX reference on the CPU, at smoke size: the reference's seeded
weights carried over with convert.lm_params_from_numpy, the same numpy
prompts of 40 tokens (past hymba's smoke window of 16 and its 8 meta
tokens) through prefill, decode_step, forward and greedy generate.

Tolerances are test_torch_lm.py's: LOGIT_TOL (f32 1e-4, bf16 3e-2) on
logits and caches, greedy tokens equal (bf16: up to the reference's
first near-tie of its top-2 logits).

MoE routes in bf16: the two packages' gates differ by up to about 1e-3
(the router's inputs differ by bf16 roundings), so a token whose k-th and
(k+1)-th gates lie that close may take another expert in the port than in
the reference, which moves that token's output by a whole expert's share.
The tests read the reference's routes (its layer functions, layer by
layer as its forward runs them) beside the port's: every token routed
differently must be such a near-tie (reference margin under ROUTE_TIE),
at most 5% of the tokens may be, and only those tokens' own positions are
left out (their logits, cache entries and the greedy steps from them on).

The reference runs compiled with XLA's excess precision off, so each
bf16 op is rounded as it is issued -- as in its own op-by-op run (equal
to it bit for bit here) and as the port computes. By default XLA keeps
bf16 intermediates in f32 inside its fusions; in llama4-scout's top-1
routing that moves one token of the seeded prompt to another expert,
0.52 in the logits against the reference's own op-by-op run (ROADMAP
queue 3).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as j_model
from repro.models import moe as j_moe
from repro.models.layers import norm as j_norm
from repro_torch.convert import (lm_params_from_numpy,
                                 model_config_from_reference_dict)
from repro_torch.models import model as t_model
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as t_moe
from repro_torch.models.model import F32_LEAVES
from repro_torch.serve.engine import generate

ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e", "mamba2-130m",
         "hymba-1.5b")
J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOGIT_TOL = {"f32": 1e-4, "bf16": 3e-2}
# 16 rows: the smoke models' logits (an lm_head or tied embedding of std
# 0.02 at width 64) are ~0.2 in magnitude, so a bf16 row's first greedy
# steps are often near-ties (top-2 within 3e-2); 16 rows leave several
# rows whose first tokens are clear
B, S, NEW = 16, 40, 8
MAX_LEN = S + NEW
ROUTE_TIE = 2.5e-3   # a route may differ below this reference gate margin

torch.set_num_threads(1)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dt, what="", skip=None):
    """Within LOGIT_TOL, but where ``skip`` (a bool mask over the leading
    axes, broadcast over the rest) is set."""
    assert tuple(got.shape) == tuple(want.shape), what
    got, want = _f32(got), _f32(want)
    if skip is not None:
        keep = ~np.broadcast_to(skip.reshape(skip.shape + (1,) * (
            got.ndim - skip.ndim)), got.shape)
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL[dt],
                               atol=LOGIT_TOL[dt], err_msg=what)


def _compile(fn, *args, **static):
    """The reference's ``fn`` (its options ``static`` fixed) compiled for
    ``args`` with XLA's excess precision off."""
    return jax.jit(functools.partial(fn, **static)).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _ref(fn, *args, **static):
    return _compile(fn, *args, **static)(*args)


@contextlib.contextmanager
def _port_routes(case):
    """Record the port's expert choices, one (T, k) sorted id tensor per
    moe._route call (one per MoE layer). Only bf16 MoE cases record: in
    f32 the gates agree to ~1e-7 and every position is compared."""
    calls, route = [], t_moe._route

    def recording(x_flat, gates, cfg, capacity):
        calls.append(torch.sort(t_moe._top_k(gates, cfg.top_k)[1]).values)
        return route(x_flat, gates, cfg, capacity)

    if case.dt == "bf16" and case.cfg.is_moe:
        t_moe._route = recording
    try:
        yield calls
    finally:
        t_moe._route = route


def _ref_routes(case, tokens):
    """The reference's expert choices ((L, B*T, k) sorted ids) and gate
    margins between the k-th and (k+1)-th gate ((L, B*T)) for a forward
    over ``tokens`` (B, T): its decoder layers one by one, as its forward
    runs them."""
    jc = case.jcfg

    def routes(jp, tok):
        x = j_model.embed_tokens(jp, tok, jc)
        pos = jnp.broadcast_to(jnp.arange(tok.shape[1])[None], tok.shape)
        ids, margins = [], []
        for i in range(jc.n_layers):
            lp = jax.tree.map(lambda t: t[i], jp["layers"])
            x = x + j_model._mixer(j_norm(x, lp["ln1"], jc.norm, jc.norm_eps),
                                   lp, jc, pos, i, None)
            h = j_norm(x, lp["ln2"], jc.norm, jc.norm_eps)
            g = jax.nn.softmax(jnp.einsum(
                "td,de->te", h.reshape(-1, jc.d_model),
                lp["moe"]["router"]).astype(jnp.float32), -1)
            w, e = jax.lax.top_k(g, jc.top_k + 1)
            ids.append(jnp.sort(e[:, :jc.top_k], -1))
            margins.append(w[:, jc.top_k - 1] - w[:, jc.top_k])
            x = x + j_moe.moe_ffn(h, lp["moe"], jc)
        return jnp.stack(ids), jnp.stack(margins)

    ids, margins = _ref(routes, case.jp, jnp.asarray(tokens))
    return np.asarray(ids), np.asarray(margins)


def _moved(case, calls, tokens, rows=slice(None)):
    """(B, t) bool: the tokens the port routed otherwise than the
    reference in some layer, at the positions ``rows`` selects of a
    forward over ``tokens`` (``calls``: the port's routes there, one
    (B*t, k) per layer); each must be a near-tie, and at most 5% of them
    (or one) may move. All False where nothing was recorded."""
    B_, T_ = tokens.shape
    if not calls:
        return np.zeros((B_, T_), bool)[:, rows]
    ids, margins = _ref_routes(case, tokens)
    L, k = case.cfg.n_layers, case.cfg.top_k
    ids = ids.reshape(L, B_, T_, k)[:, :, rows]
    margins = margins.reshape(L, B_, T_)[:, :, rows]
    got = torch.stack(calls).numpy().reshape(ids.shape)
    moved = (got != ids).any(-1)                              # (L, B, t)
    assert (margins[moved] < ROUTE_TIE).all(), margins[moved]
    per_token = moved.any(0)
    assert per_token.sum() <= max(1, 0.05 * per_token.size)
    return per_token


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's f32 smoke parameters (init_params, key 0)."""
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                               dtype=jnp.float32)
    return jax.jit(j_model.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))


class Case:
    """One arch in one dtype: both packages' configs and weights, the
    prompt, and the reference's prefill of it (run once)."""

    def __init__(self, arch, dt):
        self.arch, self.dt = arch, dt
        self.jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                                        dtype=J_DT[dt])
        # the reference's bf16 init is its f32 one cast (normal x std,
        # then astype), the SSM's f32 leaves aside
        self.jp = jax.tree_util.tree_map_with_path(
            lambda path, t: t if path[-1].key in F32_LEAVES
            else t.astype(J_DT[dt]), _ref_params(arch))
        self.cfg = model_config_from_reference_dict(
            dataclasses.asdict(self.jcfg))
        self.leaves = jax.tree.map(np.asarray, self.jp)
        self.p = lm_params_from_numpy(self.leaves, self.cfg, device="cpu")
        self.prompt = np.random.default_rng(1).integers(
            0, self.cfg.vocab, (B, S)).astype(np.int32)
        self.jl, self.jc = _ref(j_model.prefill, self.jp,
                                {"tokens": jnp.asarray(self.prompt)},
                                cfg=self.jcfg, max_len=MAX_LEN)

    @functools.cached_property
    def step(self):
        """The reference's decode_step, compiled for (B, 1) tokens."""
        return _compile(j_model.decode_step, self.jp,
                        jnp.zeros((B, 1), jnp.int32), self.jc, cfg=self.jcfg)

    def prefill(self):
        return t_model.prefill(self.p, {"tokens": torch.from_numpy(
            self.prompt).long()}, self.cfg, max_len=MAX_LEN)

    def generate(self):
        """The reference's greedy generate (repro/serve/engine.py:
        generate): its prefill, then decode_step on each argmax."""
        toks, logits, cache = [self.prompt], self.jl, self.jc
        for t in range(NEW):
            cur = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(
                jnp.int32)
            toks.append(np.asarray(cur))
            if t < NEW - 1:
                logits, cache = self.step(self.jp, cur, cache)
        return np.concatenate(toks, axis=1)


@pytest.fixture(scope="module",
                params=[(a, dt) for a in ARCHS for dt in ("f32", "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    return Case(*request.param)


def test_lm_params_from_numpy_carries_every_leaf(case):
    """Every leaf of the reference's tree, numel = param_count(); each
    in the config's dtype but A_log, D_skip and dt_bias, which stay f32
    in a bf16 model as the reference keeps them."""
    p, cfg = case.p, case.cfg
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(case.jp))
    assert sum(t.numel() for t in p.parameters()) == n_ref \
        == cfg.param_count()
    for name, t in p.named_parameters():
        want = torch.float32 if name.split(".")[-1] in F32_LEAVES \
            else T_DT[case.dt]
        assert t.dtype == want and not t.requires_grad, name
    lay = case.leaves["layers"]
    for name, t in p.layers[1].named_parameters():
        ref = functools.reduce(lambda d, k: d[k], name.split("."), lay)[1]
        np.testing.assert_array_equal(_f32(t), _f32(ref), err_msg=name)
    if cfg.meta_tokens:
        np.testing.assert_array_equal(_f32(p.meta), _f32(case.leaves["meta"]))
    if cfg.has_ssm:
        assert p.layers[0].ssm.A_log.dtype == torch.float32


def test_prefill_logits_and_cache_match_reference(case):
    with _port_routes(case) as calls:
        tl, tc = case.prefill()
    ties = _moved(case, calls, case.prompt)
    jl, jc = case.jl, case.jc
    assert tl.shape == jl.shape == (B, 1, case.cfg.vocab)
    assert tc["idx"] == int(jc["idx"]) == S + case.cfg.meta_tokens
    assert set(tc) == set(jc)
    _close(tl, jl, case.dt, "logits", skip=ties[:, -1:])
    M = case.cfg.meta_tokens
    slots = np.zeros((B, MAX_LEN + M), bool)       # cache slots left out
    slots[:, M:M + S] = ties
    for key in set(tc) - {"idx"}:
        assert tc[key].shape == jc[key].shape, key
        assert tc[key].dtype == (torch.float32 if key in ("state", "conv")
                                 else T_DT[case.dt]), key
        _close(tc[key], jc[key], case.dt, key,
               np.broadcast_to(slots, tc[key].shape[:3])
               if key in ("k", "v") else None)


def test_decode_step_matches_reference(case):
    """Two decode steps from each package's own prefill: logits, then the
    caches (KV, SSM state and conv) after them."""
    M = case.cfg.meta_tokens
    with _port_routes(case) as calls:
        _, tc = case.prefill()
    moved = np.zeros((B, MAX_LEN + M), bool)     # cache slots left out
    moved[:, M:M + S] = _moved(case, calls, case.prompt)
    jl, jc = case.jl, case.jc
    tok = np.argmax(_f32(jl)[:, -1], -1)[:, None].astype(np.int32)
    toks = [case.prompt]
    for i in range(2):
        jl, jc = case.step(case.jp, jnp.asarray(tok), jc)
        with _port_routes(case) as calls:
            tl, tc = t_model.decode_step(case.p, torch.from_numpy(tok).long(),
                                         tc, case.cfg)
        toks.append(tok)
        moved[:, M + S + i] = _moved(case, calls, np.concatenate(toks, 1),
                                     slice(-1, None))[:, 0]
        _close(tl, jl, case.dt, f"step {i}", skip=moved[:, M + S + i:][:, :1])
        assert tc["idx"] == int(jc["idx"])
        tok = (tok + 7) % case.cfg.vocab
    for key in set(tc) - {"idx"}:
        _close(tc[key], jc[key], case.dt, key,
               np.broadcast_to(moved, tc[key].shape[:3])
               if key in ("k", "v") else None)


def test_forward_matches_reference(case):
    """forward over the prompt (the meta tokens stripped from the
    logits); hymba also under ctx.banded, the reference's banded
    prefill: the same function as its masked baseline."""
    want = _ref(j_model.forward, case.jp,
                {"tokens": jnp.asarray(case.prompt)}, cfg=case.jcfg)
    x = torch.from_numpy(case.prompt).long()
    with _port_routes(case) as calls:
        got = case.p(x)
    _close(got, want, case.dt, skip=_moved(case, calls, case.prompt))
    if case.cfg.sliding_window:
        banded = t_moe.ShardingCtx(grid=make_host_mesh(device="cpu"),
                                   dp_axes=("data",), banded=True)
        _close(t_model.forward(case.p, {"tokens": x}, case.cfg, banded),
               want, case.dt, "banded")


def test_greedy_generate_matches_reference(case):
    """f32: every token equal. bf16: equal up to the first step where the
    reference's own top-2 margin is within the logit tolerance (read from
    the reference's forward over its own output), or whose token the port
    routed otherwise than the reference (an MoE near-tie)."""
    want = case.generate()
    with _port_routes(case) as calls:
        got = generate(case.p, case.cfg, case.prompt, max_new_tokens=NEW)
    assert got.shape == want.shape == (B, S + NEW)
    np.testing.assert_array_equal(got[:, :S].numpy(), case.prompt)
    if case.dt == "f32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    logits = _f32(_ref(j_model.forward, case.jp,
                       {"tokens": jnp.asarray(want[:, :-1])},
                       cfg=case.jcfg))[:, S - 1:]
    top2 = np.sort(logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > LOGIT_TOL[case.dt]
    if calls:
        # step j reads the logits of position S - 1 + j: the prompt's
        # last (the prefill's calls, B x S tokens), then each decoded
        # token's (B tokens a call); the port's decode routes are held
        # to the reference's forward over the same tokens
        L = case.cfg.n_layers
        seq = [torch.cat([calls[li].reshape(B, S, -1)[:, -1:]]
                         + [calls[L * (j + 1) + li][:, None]
                            for j in range(NEW - 1)], 1).reshape(B * NEW, -1)
               for li in range(L)]
        clear &= ~_moved(case, seq, got.numpy()[:, :-1], slice(S - 1, None))
    compared = 0
    for b in range(B):
        t = NEW if clear[b].all() else int(np.argmin(clear[b]))
        np.testing.assert_array_equal(got[b, S:S + t].numpy(),
                                      want[b, S:S + t])
        compared += t
    assert compared >= 3
