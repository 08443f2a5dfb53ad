"""The port's int8 quantizer (repro_torch.core.quant) against the JAX
reference (repro.core.quant), on the same seeded numpy inputs.

Codes, scales and rescaled scores must be identical: the port does the
same f32 operations in the same order (a multiply by f32(1/127), an IEEE
divide, round half to even). The round-trip bound is held in ulps of the
block's largest value, not with the reference's fixed 1e-7 slack, which
is below one f32 ulp for values above 1 (ROADMAP.md queue 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq


def _blocks(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "unit":                  # block-norm output, [0, 1]
        v = rng.random((300, 36))
    elif kind == "signed":
        v = rng.normal(0, 3.0, (20, 7, 36))
    elif kind == "large":
        v = rng.random((40, 36)) * 221.703125
    else:                               # mixed magnitudes and zero blocks
        v = rng.random((60, 36)) * 10.0 ** rng.integers(-6, 4, (60, 1))
        v[::7] = 0.0
    return v.astype(np.float32)


KINDS = ["unit", "signed", "large", "mixed"]


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_blocks_identical_to_reference(kind):
    v = _blocks(kind)
    wq, ws = jq.quantize_blocks(jnp.asarray(v))
    q, s = tq.quantize_blocks(torch.from_numpy(v))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(
        tq.dequantize_blocks(q, s).numpy(),
        np.asarray(jq.dequantize_blocks(wq, ws)))
    np.testing.assert_array_equal(
        tq.quantize_dequantize(torch.from_numpy(v)).numpy(),
        np.asarray(jq.quantize_dequantize(jnp.asarray(v))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_weight_columns_identical_to_reference(seed):
    rng = np.random.default_rng(seed)
    wt = rng.normal(0, 0.02, (36, 105)).astype(np.float32)
    wt[:, 3] = 0.0                                  # an all-zero column
    wq, ws = jq.quantize_weight_columns(jnp.asarray(wt))
    q, s = tq.quantize_weight_columns(torch.from_numpy(wt))
    assert q.dtype == torch.int8 and tuple(s.shape) == (105,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    assert int(q.abs().max()) == 127 and not q[:, 3].any()


def test_rescale_scores_identical_to_reference():
    rng = np.random.default_rng(4)
    ci = rng.integers(-580644, 580645, (77, 105)).astype(np.int32)
    row = rng.random(77).astype(np.float32) / 127
    col = rng.random(105).astype(np.float32) / 1e4
    want = np.asarray(jq.rescale_scores(jnp.asarray(ci), jnp.asarray(row),
                                        jnp.asarray(col)))
    got = tq.rescale_scores(torch.from_numpy(ci), torch.from_numpy(row),
                            torch.from_numpy(col)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,scale,seed", [
    (5, 221.703125, 95),        # the draw that broke the 1e-7 slack
    (16, 1e-3, 0), (1, 1.0, 1), (9, 37.5, 2), (16, 1e3, 3)])
def test_roundtrip_bound_in_ulps(n, scale, seed):
    """|dequant(quant(v)) - v| <= scale/2 + 2 ulp(max|v|) per block: half
    a code step from rint, plus one rounding each of the divide
    (<= 128 * 2^-24 * scale) and of the dequantizing multiply."""
    v = (np.random.default_rng(seed).random((n, 36)) * scale) \
        .astype(np.float32)
    q, s = tq.quantize_blocks(torch.from_numpy(v))
    back = tq.dequantize_blocks(q, s).numpy().astype(np.float64)
    m = np.abs(v).max(-1, keepdims=True)
    bound = s.numpy().astype(np.float64)[:, None] / 2 + 2 * np.spacing(m)
    assert (np.abs(back - v.astype(np.float64)) <= bound).all()
    assert int(q.abs().max()) <= 127


def test_requantize_recovers_codes_exactly():
    """Requantizing a dequantized grid gives the same codes and scales:
    what score_blocks relies on."""
    for kind in KINDS:
        v = torch.from_numpy(_blocks(kind, seed=5))
        q, s = tq.quantize_blocks(v)
        q2, s2 = tq.quantize_blocks(tq.dequantize_blocks(q, s))
        assert torch.equal(q, q2), kind
        torch.testing.assert_close(s2, s, rtol=1e-6, atol=0)


def test_zero_blocks_dequantize_to_zero():
    q, s = tq.quantize_blocks(torch.zeros(3, 36))
    assert not q.any() and not s.any()
    assert not tq.dequantize_blocks(q, s).any()
