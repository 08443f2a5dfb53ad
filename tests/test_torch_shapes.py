"""The port's shape set (repro_torch/configs/registry.py) against the
reference's (repro/configs/registry.py:38-109), its roofline's
``model_flops``, and the passes that let one card hold the reference's
longest shape:

  * SHAPES, SHAPE_BY_NAME and every arch's skip decision (full and smoke
    configs) equal the reference's, reason strings included;
  * ``input_specs`` and ``cache_specs`` give the reference's shapes and
    dtypes for every arch x shape, smoke and full (meta tensors against
    ``jax.ShapeDtypeStruct``; the cache's "idx" is a Python int 0 where
    the reference's is an int32 scalar);
  * ``analysis/roofline.py:model_flops`` equals the reference's in every
    cell, on 256 and 512 devices;
  * ``models/ssm.py:ssd_forward`` and ``models/attention.py:banded_core``
    in several passes (a small ``models/layers.py:PASS_BYTES``) give what
    one pass gives, bit for bit: the passes cut whole chunks or blocks
    apart, each computed by the same ops.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analysis import roofline as ref_roofline
from repro.configs import registry as ref_reg
from repro_torch.analysis import roofline
from repro_torch.configs import registry as reg

ARCHS = reg.ARCH_IDS
DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32,
          jnp.bfloat16: torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype(d) -> torch.dtype:
    return DTYPES[jnp.dtype(d).type]


def test_shape_set_is_the_references():
    assert reg.ARCH_IDS == ref_reg.ARCH_IDS
    assert [dataclasses.astuple(s) for s in reg.SHAPES] == \
        [dataclasses.astuple(s) for s in ref_reg.SHAPES]
    assert [(s.name, s.seq_len, s.global_batch, s.kind)
            for s in reg.SHAPES] == [
        ("train_4k", 4096, 256, "train"), ("prefill_32k", 32768, 32,
                                           "prefill"),
        ("decode_32k", 32768, 128, "decode"), ("long_500k", 524288, 1,
                                               "decode")]
    assert sorted(reg.SHAPE_BY_NAME) == sorted(ref_reg.SHAPE_BY_NAME)
    for name, s in reg.SHAPE_BY_NAME.items():
        assert dataclasses.astuple(s) == \
            dataclasses.astuple(ref_reg.SHAPE_BY_NAME[name])


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_skip_decisions_are_the_references(arch, smoke):
    cfg, rcfg = reg.get_config(arch, smoke), ref_reg.get_config(arch, smoke)
    assert cfg.sub_quadratic == rcfg.sub_quadratic
    for s in reg.SHAPES:
        assert reg.shape_applicable(cfg, s) == ref_reg.shape_applicable(
            rcfg, ref_reg.SHAPE_BY_NAME[s.name])
    with pytest.raises(ValueError, match="hog_svm_coproc"):
        reg.get_config("hog_svm_coproc")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_are_the_references(arch, smoke):
    cfg, rcfg = reg.get_config(arch, smoke), ref_reg.get_config(arch, smoke)
    for s in reg.SHAPES:
        rs = ref_reg.SHAPE_BY_NAME[s.name]
        got, want = reg.input_specs(cfg, s, smoke), ref_reg.input_specs(
            rcfg, rs, smoke)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert (tuple(v.shape), v.dtype) == (tuple(want[k].shape),
                                                 _dtype(want[k].dtype)), k
        if s.kind != "decode":
            continue
        got = reg.cache_specs(cfg, s, smoke)
        want = ref_reg.cache_specs(rcfg, rs, smoke)
        assert sorted(got) == sorted(want)
        assert got["idx"] == 0 and want["idx"].shape == () \
            and want["idx"].dtype == jnp.int32
        for k, v in got.items():
            if k == "idx":
                continue
            assert v.device.type == "meta"
            assert (tuple(v.shape), v.dtype) == (tuple(want[k].shape),
                                                 _dtype(want[k].dtype)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_are_the_references(arch):
    cfg, rcfg = reg.get_config(arch), ref_reg.get_config(arch)
    for s in reg.SHAPES:
        for n in (256, 512):
            assert roofline.model_flops(cfg, s, n) == \
                ref_roofline.model_flops(rcfg, ref_reg.SHAPE_BY_NAME[s.name],
                                         n)
    # a batch in place of the global batch (chip_smoke.py's one-card cells)
    s = reg.SHAPE_BY_NAME["prefill_32k"]
    assert roofline.model_flops(cfg, s, 1, batch=1) == \
        roofline.model_flops(cfg, s, 32) * 1


def test_roofline_terms_on_the_h100():
    r = roofline.Roofline("x", flops_dev=989.4e12, mem_bytes_dev=6.7e12,
                          coll_bytes_dev=450e9, model_flops_dev=494.7e12)
    assert (r.t_compute, r.t_memory, r.t_coll) == (1.0, 2.0, 1.0)
    assert r.bottleneck == "memory" and r.step_time == 2.0
    assert r.useful_flops_frac == 0.5 and r.mfu == 0.25
    assert list(r.row()) == list(ref_roofline.Roofline(
        "x", 1.0, 1.0, 1.0).row())


def _ssd_inputs(cfg, S, seed=0):
    from repro_torch.models.model import init_params
    p = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model), dtype=np.float32)).to(cfg.dtype)
    return p.layers[0].ssm, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_passes_give_one_pass_bit_for_bit(monkeypatch, dtype):
    import repro_torch.models.layers as layers
    import repro_torch.models.ssm as ssm
    cfg = dataclasses.replace(reg.get_config("mamba2-130m", smoke=True),
                              dtype=dtype)
    p, x = _ssd_inputs(cfg, 8 * cfg.ssm_chunk - 5)   # 8 chunks, a ragged one
    per_chunk = 4 * 2 * cfg.ssm_chunk ** 2 * cfg.ssm_heads
    assert len(layers.passes(8, per_chunk)) == 1
    one, cache1 = ssm.ssd_forward(x, p, cfg)
    monkeypatch.setattr(layers, "PASS_BYTES", 3 * per_chunk)
    assert [(c.start, c.stop) for c in layers.passes(8, per_chunk)] == \
        [(0, 3), (3, 6), (6, 8)]
    many, cache3 = ssm.ssd_forward(x, p, cfg)
    assert torch.equal(one, many)
    for k in ("state", "conv"):
        assert torch.equal(cache1[k], cache3[k])


@pytest.mark.parametrize("bf16", [False, True])
def test_banded_passes_give_one_pass_bit_for_bit(monkeypatch, bf16):
    import repro_torch.models.attention as att
    import repro_torch.models.layers as layers
    from repro_torch.launch.mesh import grid_of
    from repro_torch.sharding.rules import make_ctx
    cfg = reg.get_config("hymba-1.5b", smoke=True)
    rng = np.random.default_rng(1)
    B, S, H, K, hd = 2, 5 * cfg.sliding_window + 3, cfg.n_heads, \
        cfg.n_kv_heads, cfg.hd
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, S, n, hd), dtype=np.float32)).to(torch.bfloat16)
        for n in (H, K, K))
    pos = torch.arange(S).expand(B, S)
    ctx = dataclasses.replace(make_ctx(grid_of(
        (torch.device("cpu"),), (1, 1), ("data", "model"))),
        bf16_scores=bf16)
    kw = dict(window=cfg.sliding_window, n_meta=cfg.meta_tokens, ctx=ctx)
    one = att.banded_core(q, k, v, pos, cfg, **kw)
    w = cfg.sliding_window
    block = 4 * H * w * 2 * w          # a block's f32 scores
    # two blocks a pass (12 blocks: 6 passes), 7 queries a meta pass
    monkeypatch.setattr(layers, "PASS_BYTES", 2 * block)
    assert len(layers.passes(B * 6, block)) == 6
    assert torch.equal(one, att.banded_core(q, k, v, pos, cfg, **kw))
    monkeypatch.setattr(layers, "PASS_BYTES", 4 * B * H * cfg.meta_tokens * 7)
    assert len(layers.passes(S, 4 * B * H * cfg.meta_tokens)) == -(-S // 7)
    assert torch.equal(one, att.banded_core(q, k, v, pos, cfg, **kw))
