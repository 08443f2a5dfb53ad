"""The port's LM serving path for the encoder-decoder (whisper-large-v3)
and VLM (qwen2-vl-72b, M-RoPE) families against the JAX reference on the
CPU, at smoke size: the reference's seeded weights (its norms' scales
and biases redrawn from a numpy seed, so every bias and scale is read)
carried over with convert.lm_params_from_numpy, the same numpy prompts,
frame embeddings and positions through encode, prefill, decode_step,
forward and whisper's greedy generate.

qwen2-vl runs two prompt groups: ``text`` (t = h = w = arange) and
``image`` (8 text tokens, a 4 x 4 patch grid at one t with h and w over
the grid, then text again, laid out as Qwen2-VL's rope index does). The
reference's generate cannot pass positions (it raises IndexError), so
its VLM path is prefill + decode_step, and so is the port's.

Tolerances are test_torch_lm.py's: LOGIT_TOL (f32 1e-4, bf16 3e-2) on
logits, caches and encoder states; layers f32 1e-5, bf16 one ulp of the
output relative (norms, rotations) or LOGIT_TOL (matmul chains). Greedy
tokens equal (bf16: up to the reference's first near-tie of its top-2
logits). The reference runs compiled with XLA's excess precision off, as
in tests/test_torch_lm_families_archs.py.
"""
import dataclasses
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import model as j_model
from repro_torch.configs import get_config
from repro_torch.convert import (lm_params_from_numpy,
                                 model_config_from_reference_dict)
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.serve.engine import generate

J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOGIT_TOL = {"f32": 1e-4, "bf16": 3e-2}
BF16_ULP = 2.0 ** -8
DTS = ("f32", "bf16")
WHISPER, VLM = "whisper-large-v3", "qwen2-vl-72b"
# 16 rows: the smoke models' logits are ~0.2 in magnitude, so several
# rows' first bf16 greedy steps are clear of the tolerance
B, S, NEW = 16, 24, 6
MAX_LEN = S + NEW
VLM_S = 28                      # 8 text + 4 x 4 patches + 4 text

torch.set_num_threads(1)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    assert tuple(got.shape) == tuple(want.shape), what
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol,
                               err_msg=what)


def _compile(fn, *args):
    """The reference's ``fn`` compiled for ``args`` with XLA's excess
    precision off (each bf16 op rounded as issued, as the port does)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _ref(fn, *args):
    return _compile(fn, *args)(*args)


def image_positions(n_text: int, grid: int, n_after: int, B_: int):
    """(B, n_text + grid^2 + n_after, 3) int32 positions of a prompt of
    n_text text tokens, a grid x grid patch image and n_after text tokens,
    as Qwen2-VL's rope index lays them out: text t = h = w = i; the
    image's patches at t = n_text, h = n_text + row, w = n_text + col;
    the text after it from the largest position so far + 1."""
    txt = np.repeat(np.arange(n_text)[:, None], 3, 1)
    r, c = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    img = np.stack([np.zeros(grid * grid, int), r.ravel(), c.ravel()],
                   1) + n_text
    after = np.repeat((np.arange(n_after) + img.max() + 1)[:, None], 3, 1)
    pos = np.concatenate([txt, img, after]).astype(np.int32)
    return np.broadcast_to(pos, (B_,) + pos.shape).copy()


def text_positions(S_: int, B_: int):
    return np.broadcast_to(np.arange(S_, dtype=np.int32)[:, None],
                           (B_, S_, 3)).copy()


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's f32 smoke parameters (init_params, key 0), each
    norm's scale 1 + 0.1 N(0, 1) and bias 0.1 N(0, 1) from a numpy seed."""
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                               dtype=jnp.float32)
    jp = jax.jit(j_model.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)

    def redraw(path, t):
        name = path[-1].key
        if name in ("scale", "bias") and path[-2].key != "ssm":
            x = 0.1 * rng.standard_normal(t.shape).astype(np.float32)
            return jnp.asarray(x + (name == "scale"))
        return t
    return jax.tree_util.tree_map_with_path(redraw, jp)


class Case:
    """One arch in one dtype: both packages' configs and weights."""

    def __init__(self, arch, dt):
        self.arch, self.dt = arch, dt
        self.jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                                        dtype=J_DT[dt])
        self.jp = jax.tree.map(lambda t: t.astype(J_DT[dt]),
                               _ref_params(arch))
        self.cfg = model_config_from_reference_dict(
            dataclasses.asdict(self.jcfg))
        self.leaves = jax.tree.map(np.asarray, self.jp)
        self.p = lm_params_from_numpy(self.leaves, self.cfg, device="cpu")
        self.tol = LOGIT_TOL[dt]


class Whisper(Case):
    """whisper's prompt and seeded frame embeddings, and the reference's
    encode and prefill of them (run once)."""

    def __init__(self, dt):
        super().__init__(WHISPER, dt)
        rng = np.random.default_rng(1)
        self.prompt = rng.integers(0, self.cfg.vocab, (B, S)).astype(
            np.int32)
        self.frames = rng.standard_normal(
            (B, self.cfg.encoder_ctx, self.cfg.d_model)).astype(np.float32)
        jc = self.jcfg
        self.jenc = _ref(lambda p, e: j_model.encode(p, e, jc), self.jp,
                         jnp.asarray(self.frames))
        self.jl, self.jc = _ref(
            lambda p, b: j_model.prefill(p, b, jc, MAX_LEN), self.jp,
            {"tokens": jnp.asarray(self.prompt),
             "enc_input": jnp.asarray(self.frames)})

    @functools.cached_property
    def step(self):
        jc = self.jcfg
        return _compile(lambda p, t, c, e: j_model.decode_step(p, t, c, jc,
                                                               enc=e),
                        self.jp, jnp.zeros((B, 1), jnp.int32), self.jc,
                        self.jenc)

    def batch(self):
        return {"tokens": torch.from_numpy(self.prompt).long(),
                "enc_input": self.frames}

    def generate(self):
        """The reference's greedy generate (repro/serve/engine.py:
        generate): its prefill, then decode_step on each argmax with the
        encoder states."""
        toks, logits, cache = [self.prompt], self.jl, self.jc
        for t in range(NEW):
            cur = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(
                jnp.int32)
            toks.append(np.asarray(cur))
            if t < NEW - 1:
                logits, cache = self.step(self.jp, cur, cache, self.jenc)
        return np.concatenate(toks, axis=1)


class Vlm(Case):
    """qwen2-vl's two prompt groups and the reference's prefill of each
    (run once)."""

    def __init__(self, dt):
        super().__init__(VLM, dt)
        self.prompt = np.random.default_rng(1).integers(
            0, self.cfg.vocab, (B, VLM_S)).astype(np.int32)
        self.positions = {"text": text_positions(VLM_S, B),
                          "image": image_positions(8, 4, 4, B)}
        jc = self.jcfg
        fn = _compile(lambda p, b: j_model.prefill(p, b, jc, VLM_S + NEW),
                      self.jp, self.jbatch("text"))
        self.ref = {g: fn(self.jp, self.jbatch(g)) for g in self.positions}

    def jbatch(self, g):
        return {"tokens": jnp.asarray(self.prompt),
                "positions": jnp.asarray(self.positions[g])}

    def batch(self, g):
        return {"tokens": torch.from_numpy(self.prompt).long(),
                "positions": torch.from_numpy(self.positions[g])}

    @functools.cached_property
    def step(self):
        jc = self.jcfg
        return _compile(lambda p, t, c: j_model.decode_step(p, t, c, jc),
                        self.jp, jnp.zeros((B, 1), jnp.int32),
                        self.ref["text"][1])


@pytest.fixture(scope="module", params=DTS)
def whisper(request):
    return Whisper(request.param)


@pytest.fixture(scope="module", params=DTS)
def vlm(request):
    return Vlm(request.param)


# ------------------------------------------------------------ layers

def _x(shape, seed, dt):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, J_DT[dt]), torch.from_numpy(x).to(T_DT[dt])


@pytest.mark.parametrize("dt", DTS)
def test_layernorm_and_norm_dispatch_match_reference(dt):
    jx, tx = _x((3, 7, 64), 0, dt)
    rng = np.random.default_rng(1)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = j_layers.layernorm(3 * jx + 1, jnp.asarray(scale, J_DT[dt]),
                              jnp.asarray(bias, J_DT[dt]))
    p = type("P", (), {"scale": torch.from_numpy(scale).to(T_DT[dt]),
                       "bias": torch.from_numpy(bias).to(T_DT[dt])})
    tol = 1e-5 if dt == "f32" else BF16_ULP
    for got in (t_layers.layernorm(3 * tx + 1, p.scale, p.bias),
                t_layers.norm(3 * tx + 1, p, "layernorm", 1e-5)):
        assert got.dtype == T_DT[dt]
        _close(got, want, tol)
    _close(t_layers.norm(tx, p, "rmsnorm", 1e-5),
           j_layers.norm(jx, {"scale": jnp.asarray(scale, J_DT[dt])},
                         "rmsnorm", 1e-5), tol)
    with pytest.raises(ValueError, match="'batchnorm'"):
        t_layers.norm(tx, p, "batchnorm", 1e-5)


@pytest.mark.parametrize("dt", DTS)
def test_gelu_mlp_matches_reference(dt):
    """gelu's tanh approximation (jax.nn.gelu's default), through mlp's
    dispatch too."""
    jx, tx = _x((2, 5, 64), 2, dt)
    rng = np.random.default_rng(3)
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_up", (64, 128)), ("w_down", (128, 64)))}
    want = j_layers.gelu_mlp(jx, {k: jnp.asarray(v, J_DT[dt])
                                  for k, v in w.items()})
    p = type("P", (), {k: torch.from_numpy(v).to(T_DT[dt])
                       for k, v in w.items()})
    for got in (t_layers.gelu_mlp(tx, p), t_layers.mlp(tx, p, "gelu")):
        _close(got, want, 1e-5 if dt == "f32" else LOGIT_TOL[dt])
    with pytest.raises(ValueError, match="'relu'"):
        t_layers.mlp(tx, p, "relu")


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("group", ["text", "image", "far"])
def test_apply_mrope_matches_reference(group, dt):
    """M-RoPE at hd 128 with qwen2-vl's sections (16, 24, 24); on text
    positions it equals RoPE of the t stream."""
    jx, tx = _x((2, 40, 4, 128), 4, dt)
    pos = {"text": text_positions(40, 2), "image": image_positions(8, 4, 16, 2),
           "far": image_positions(8, 4, 16, 2) + 30_000}[group]
    want = j_layers.apply_mrope(jx, jnp.asarray(pos), 1e6, (16, 24, 24))
    got = t_layers.apply_mrope(tx, torch.from_numpy(pos), 1e6, (16, 24, 24))
    tol = 1e-5 if dt == "f32" else BF16_ULP
    _close(got, want, tol)
    if group == "text":
        _close(t_layers.apply_rope(tx, torch.from_numpy(pos[..., 0]), 1e6),
               got, 0)
    with pytest.raises(ValueError, match="sections"):
        t_layers.apply_mrope(tx, torch.from_numpy(pos), 1e6, (16, 24, 23))


def test_sinusoidal_positions_match_reference():
    """The (n, d) table, [sin | cos] halves, within one f32 ulp of its
    largest angle (n: the f32 pow of the two libraries may round an angle
    the other way; 411 of 1,920,000 elements at 1500 x 1280 do, by up to
    3.1e-5); a row alone (the decoder's decode-step row, clamped to the
    reference's 32,776-row table) equals that row of the table."""
    for n, d in ((32, 64), (1500, 1280)):
        want = np.asarray(j_layers.sinusoidal_positions(n, d))
        got = t_layers.sinusoidal_positions(n, d).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=n * 2.0 ** -23)
    table = t_layers.sinusoidal_positions(t_model.DECODER_PE_ROWS, 64)
    for idx in (0, 255, 32775, 40000):
        np.testing.assert_array_equal(
            t_model.decoder_pe(idx, 64, "cpu").numpy(),
            table[min(idx, 32775)][None].numpy())


def test_cross_attention_matches_reference(whisper):
    """Sq 12 against Sk 32 (whisper's smoke encoder_ctx): no RoPE, no
    mask, through _sdpa with mask None."""
    dt = whisper.dt
    jlp = jax.tree.map(lambda t: t[1], whisper.jp["layers"]["xattn"])
    jx, tx = _x((2, 12, 64), 6, dt)
    je, te = _x((2, 32, 64), 7, dt)
    want = j_attn.cross_attention(jx, je, jlp, whisper.jcfg)
    with torch.inference_mode():
        got = t_attn.cross_attention(tx, te, whisper.p.layers[1].xattn,
                                     whisper.cfg)
    _close(got, want, 1e-5 if dt == "f32" else LOGIT_TOL[dt])


def test_noncausal_attention_matches_reference(whisper):
    """The encoder's attention (causal=False, RoPE at arange) through the
    flash route's plain version, against the reference's masked _sdpa
    with its all-True mask; make_mask(causal=False) is that mask."""
    dt = whisper.dt
    jlp = jax.tree.map(lambda t: t[0], whisper.jp["enc_layers"]["attn"])
    jx, tx = _x((2, 32, 64), 8, dt)
    pos = jnp.broadcast_to(jnp.arange(32)[None], (2, 32))
    want = _ref(lambda x, p: j_attn.attention(x, p, whisper.jcfg, pos,
                                              causal=False), jx, jlp)
    with torch.inference_mode():
        got = t_attn.attention(tx, whisper.p.enc_layers[0].attn, whisper.cfg,
                               causal=False)
    _close(got, want, 1e-5 if dt == "f32" else LOGIT_TOL[dt])
    p = torch.arange(5)[None]
    np.testing.assert_array_equal(
        t_attn.make_mask(p, p, causal=False).numpy(),
        np.asarray(j_attn.make_mask(jnp.arange(5)[None], jnp.arange(5)[None],
                                    causal=False)))


# ------------------------------------------------------------ whisper

def _carries_every_leaf(case):
    """Every leaf of the reference's tree (the encoder's, xattn, ln_x and
    the layernorm biases included), numel = param_count(), in the
    config's dtype; init_params builds the same tree."""
    p, cfg = case.p, case.cfg
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(case.jp))
    assert sum(t.numel() for t in p.parameters()) == n_ref \
        == cfg.param_count()
    mine = dict(p.named_parameters())
    for path, leaf in jax.tree_util.tree_leaves_with_path(case.leaves):
        keys = [k.key for k in path]
        if keys[0] in ("layers", "enc_layers"):
            for i in (0, cfg.n_layers - 1):
                name = ".".join([keys[0], str(i)] + keys[1:])
                np.testing.assert_array_equal(_f32(mine[name]),
                                              _f32(leaf[i]), err_msg=name)
        else:
            np.testing.assert_array_equal(_f32(mine[".".join(keys)]),
                                          _f32(leaf))
    assert all(t.dtype == T_DT[case.dt] for t in mine.values())
    init = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(t.shape) for k, t in init.named_parameters()} == \
        {k: tuple(t.shape) for k, t in mine.items()}


def test_whisper_lm_params_from_numpy_carries_every_leaf(whisper):
    _carries_every_leaf(whisper)
    assert bool((whisper.p.enc_norm.bias != 0).all())


def test_vlm_lm_params_from_numpy_carries_every_leaf(vlm):
    _carries_every_leaf(vlm)


def test_encode_matches_reference(whisper):
    got = t_model.encode(whisper.p, whisper.frames, whisper.cfg)
    assert got.dtype == T_DT[whisper.dt]
    _close(got, whisper.jenc, whisper.tol, "encoder states")


def test_whisper_prefill_logits_and_cache_match_reference(whisper,
                                                          monkeypatch):
    """Logits and cache; flash runs once per encoder layer (every key
    visible) and once per decoder layer (causal), no other attention
    self-attends through it."""
    calls = []
    flash = t_attn.flash_attention

    def counting(q, k, v, causal=True):
        calls.append(causal)
        return flash(q, k, v, causal=causal)

    monkeypatch.setattr(t_attn, "flash_attention", counting)
    tl, tc = t_model.prefill(whisper.p, whisper.batch(), whisper.cfg,
                             MAX_LEN)
    cfg = whisper.cfg
    assert calls == [False] * cfg.encoder_layers + [True] * cfg.n_layers
    assert tl.shape == whisper.jl.shape == (B, 1, cfg.vocab)
    assert tc["idx"] == int(whisper.jc["idx"]) == S
    assert set(tc) == set(whisper.jc)
    _close(tl, whisper.jl, whisper.tol, "logits")
    for key in ("k", "v"):
        assert tc[key].dtype == T_DT[whisper.dt]
        _close(tc[key], whisper.jc[key], whisper.tol, key)
    # the encoder states given instead of the frames: the same function
    enc = t_model.encode(whisper.p, whisper.frames, cfg)
    tl2, _ = t_model.prefill(whisper.p, {"tokens": whisper.batch()["tokens"]},
                             cfg, MAX_LEN, enc=enc)
    assert torch.equal(tl2, tl)
    with pytest.raises(ValueError, match="enc_input"):
        t_model.prefill(whisper.p, {"tokens": whisper.batch()["tokens"]},
                        cfg, MAX_LEN)


def test_whisper_decode_steps_match_reference(whisper):
    """Two decode steps from each package's own prefill, with each one's
    encoder states: logits, then the caches."""
    _, tc = t_model.prefill(whisper.p, whisper.batch(), whisper.cfg, MAX_LEN)
    enc = t_model.encode(whisper.p, whisper.frames, whisper.cfg)
    jl, jc = whisper.jl, whisper.jc
    tok = np.argmax(_f32(jl)[:, -1], -1)[:, None].astype(np.int32)
    for i in range(2):
        jl, jc = whisper.step(whisper.jp, jnp.asarray(tok), jc, whisper.jenc)
        tl, tc = t_model.decode_step(whisper.p, torch.from_numpy(tok).long(),
                                     tc, whisper.cfg, enc=enc)
        _close(tl, jl, whisper.tol, f"step {i}")
        assert tc["idx"] == int(jc["idx"]) == S + i + 1
        tok = (tok + 7) % whisper.cfg.vocab
    for key in ("k", "v"):
        _close(tc[key], jc[key], whisper.tol, key)


def test_whisper_forward_matches_reference(whisper):
    jc = whisper.jcfg
    want = _ref(lambda p, b: j_model.forward(p, b, jc), whisper.jp,
                {"tokens": jnp.asarray(whisper.prompt),
                 "enc_input": jnp.asarray(whisper.frames)})
    _close(t_model.forward(whisper.p, whisper.batch(), whisper.cfg), want,
           whisper.tol)


def test_whisper_greedy_generate_matches_reference(whisper):
    """generate with enc_input: f32 every token equal; bf16 equal up to
    the first step where the reference's own top-2 margin is within the
    logit tolerance (read from its forward over its own output)."""
    want = whisper.generate()
    got = generate(whisper.p, whisper.cfg, whisper.prompt, NEW,
                   enc_input=whisper.frames)
    assert got.shape == want.shape == (B, S + NEW)
    np.testing.assert_array_equal(got[:, :S].numpy(), whisper.prompt)
    if whisper.dt == "f32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    jc = whisper.jcfg
    logits = _f32(_ref(lambda p, b: j_model.forward(p, b, jc), whisper.jp,
                       {"tokens": jnp.asarray(want[:, :-1]),
                        "enc_input": jnp.asarray(whisper.frames)}))[:, S - 1:]
    top2 = np.sort(logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > whisper.tol
    compared = 0
    for b in range(B):
        t = NEW if clear[b].all() else int(np.argmin(clear[b]))
        np.testing.assert_array_equal(got[b, S:S + t].numpy(),
                                      want[b, S:S + t])
        compared += t
    assert compared >= 3
    with pytest.raises(ValueError, match="enc_input"):
        generate(whisper.p, whisper.cfg, whisper.prompt, NEW)


# ------------------------------------------------------------ qwen2-vl

@pytest.mark.parametrize("group", ["text", "image"])
def test_vlm_prefill_and_decode_match_reference(vlm, group):
    """prefill with (B, S, 3) positions (logits and cache), then two
    decode steps at idx on all three streams (logits, then the caches)."""
    jl, jc = vlm.ref[group]
    tl, tc = t_model.prefill(vlm.p, vlm.batch(group), vlm.cfg, VLM_S + NEW)
    assert tl.shape == jl.shape and tc["idx"] == int(jc["idx"]) == VLM_S
    _close(tl, jl, vlm.tol, "prefill logits")
    for key in ("k", "v"):
        _close(tc[key], jc[key], vlm.tol, key)
    tok = np.argmax(_f32(jl)[:, -1], -1)[:, None].astype(np.int32)
    for i in range(2):
        jl, jc = vlm.step(vlm.jp, jnp.asarray(tok), jc)
        tl, tc = t_model.decode_step(vlm.p, torch.from_numpy(tok).long(), tc,
                                     vlm.cfg)
        _close(tl, jl, vlm.tol, f"step {i}")
        tok = (tok + 7) % vlm.cfg.vocab
    for key in ("k", "v"):
        _close(tc[key], jc[key], vlm.tol, key)


@pytest.mark.parametrize("group", ["text", "image"])
def test_vlm_forward_matches_reference(vlm, group):
    jc = vlm.jcfg
    want = _ref(lambda p, b: j_model.forward(p, b, jc), vlm.jp,
                vlm.jbatch(group))
    _close(t_model.forward(vlm.p, vlm.batch(group), vlm.cfg), want, vlm.tol)


def test_vlm_flash_only_where_t_strictly_rises(vlm, monkeypatch):
    """The route: text positions (a host copy, t rising) take flash once
    a layer; image positions (t repeats over the patches) take _sdpa
    under the t-stream mask; so does a positions tensor not on the host
    (never read: that would wait for the device), giving the text
    group's logits all the same. M-RoPE needs (B, S, 3) positions:
    prefill without them and generate raise ValueError."""
    calls = []
    flash = t_attn.flash_attention

    def counting(q, k, v, causal=True):
        calls.append(causal)
        return flash(q, k, v, causal=causal)

    monkeypatch.setattr(t_attn, "flash_attention", counting)
    out = {}
    for g in ("text", "image"):
        calls.clear()
        out[g] = t_model.prefill(vlm.p, vlm.batch(g), vlm.cfg, VLM_S)[0]
        assert calls == ([True] * vlm.cfg.n_layers if g == "text" else [])
    calls.clear()
    batch = {"tokens": vlm.batch("text")["tokens"],
             "positions": vlm.positions["text"]}       # numpy: a host copy
    assert torch.equal(t_model.prefill(vlm.p, batch, vlm.cfg, VLM_S)[0],
                       out["text"])
    assert calls == [True] * vlm.cfg.n_layers
    assert t_attn.index_causal(vlm.positions["text"])
    assert not t_attn.index_causal(vlm.positions["image"])
    assert not t_attn.index_causal(torch.from_numpy(
        vlm.positions["text"]).to("meta"))
    assert t_attn.index_causal(None)
    with pytest.raises(ValueError, match="positions"):
        t_model.prefill(vlm.p, {"tokens": batch["tokens"]}, vlm.cfg, VLM_S)
    with pytest.raises(ValueError, match="positions"):
        t_model.prefill(vlm.p, {"tokens": batch["tokens"],
                                "positions": vlm.positions["text"][..., 0]},
                        vlm.cfg, VLM_S)
    with pytest.raises(ValueError, match=r"\(B, S, 3\) positions"):
        generate(vlm.p, vlm.cfg, vlm.prompt, 2)


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_decode_consistency_catches_planted_faults(arch):
    """chip_smoke.py's f32 check, on the CPU at smoke size with 4 layers:
    prefill and prefill[:-1] + decode_step agree to summation order, under
    the limit (1e-3; qwen2-vl's 1e-4), and each planted fault lands above
    it -- whisper's
    cross-attention reading another row's encoder states ("enc-row") and
    its sinusoidal row one past ("pe+1"); qwen2-vl's h stream one past
    ("mrope-h+1") and the new key and value one slot early ("kv@idx-1"),
    on chip_smoke's image layout (Qwen2-VL's rope index: equal to this
    file's) with the last token at S - 1 on all three streams."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = dataclasses.replace(get_config(arch, smoke=True), n_layers=4,
                              dtype=torch.float32)
    p = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 40), generator=g)
    kw = {}
    if cfg.encoder_layers:
        kw["enc"] = t_model.encode(p, torch.randn(
            2, cfg.encoder_ctx, cfg.d_model, generator=g), cfg)
        want = {"sound", "enc-row", "pe+1"}
    else:
        pos = chip_smoke.vlm_positions(np, "image", 2, 40,
                                       chip_smoke.VLM_SMOKE_IMAGE)
        np.testing.assert_array_equal(pos, image_positions(8, 4, 16, 2))
        np.testing.assert_array_equal(
            chip_smoke.vlm_positions(np, "image", 1, 512)[0, 287:290],
            [[32, 47, 47], [48, 48, 48], [49, 49, 49]])
        pos[:, -1] = 39
        kw["positions"] = pos
        want = {"sound", "mrope-h+1", "kv@idx-1"}
    _, _, rel = chip_smoke.decode_consistency(torch, p, cfg, tok, **kw)
    tol = chip_smoke.CONSIST_TOL_F32_VLM if cfg.mrope \
        else chip_smoke.CONSIST_TOL_F32
    assert set(rel) == want
    assert rel["sound"] <= tol
    assert min(v for k, v in rel.items() if k != "sound") > tol
