"""The port's flash attention (repro_torch.kernels.flash_attention) on CPU
tensors -- its plain version -- against the JAX Pallas kernel it
replaces, run as tests/test_flash_kernel.py runs it (interpret mode),
and against the reference's oracle kernels/ref.py:flash_attention_ref,
on the same numpy-seeded inputs. The CUDA kernel itself runs only on the
card: chip_smoke.py holds it against this plain version there.

Tolerances are the reference's own flash tests': f32 1e-5 (summation
order and the divide-or-multiply scale), bf16 3e-2 (the oracle rounds
scores and weights to bf16 where the Pallas kernel keeps f32 scores and
an unnormalized bf16 p). Ragged S is held to the oracle only: the Pallas
kernel asserts S is a multiple of its block.
"""
import math
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 smem_bytes)
from repro_torch.models.attention import _sdpa, attend, make_mask
from repro_torch.models.configs import ModelConfig

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its checks' plain versions)

TOL = {"f32": 1e-5, "bf16": 3e-2}
J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _qkv(B, H, K, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, S, hd)).astype(np.float32),
            rng.normal(size=(B, K, S, hd)).astype(np.float32),
            rng.normal(size=(B, K, S, hd)).astype(np.float32))


def _port(arrays, dt):
    return [torch.from_numpy(a).to(T_DT[dt]) for a in arrays]


def _jax(arrays, dt):
    return [jnp.asarray(a, J_DT[dt]) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_oracle(causal, rep, dt):
    """The JAX tests' shapes: B 2, K 2, S 64 (a multiple of the Pallas
    blocks), hd 16."""
    arrays = _qkv(2, 2 * rep, 2, 64, 16, seed=rep)
    got = flash_attention(*_port(arrays, dt), causal=causal)
    assert got.dtype == T_DT[dt] and got.shape == (2, 2 * rep, 64, 16)
    block = 16 if dt == "f32" else 32
    pallas = j_flash(*_jax(arrays, dt), causal=causal, block_q=block,
                     block_k=block)
    oracle = j_flash_ref(*_jax(arrays, dt), causal=causal)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dt],
                                   atol=TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,hd", [(37, 8), (100, 16), (128, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_and_tile_multiple_S_match_oracle(causal, S, hd,
                                                             dt):
    arrays = _qkv(1, 4, 2, S, hd, seed=S)
    got = flash_attention(*_port(arrays, dt), causal=causal)
    want = j_flash_ref(*_jax(arrays, dt), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dt],
                               atol=TOL[dt])


def test_flash_row_sums_preserved():
    """Softmax rows sum to 1: attention over a constant V returns V."""
    q, k, _ = _port(_qkv(1, 2, 2, 64, 8), "f32")
    v = torch.full((1, 2, 64, 8), 3.0)
    np.testing.assert_allclose(flash_attention(q, k, v).numpy(), 3.0,
                               rtol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_route_equals_sdpa_with_causal_mask(dt):
    """LM prefill's flash route (strided (B, S, H, hd) views, output in
    the same layout) against the plain einsum attention with the causal
    make_mask, the port's decode path. bf16: _sdpa rounds its scores to
    bf16 and scales after, the oracle scales in bf16 first."""
    B, S, H, K, hd = 2, 40, 8, 2, 16
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, n, hd)).astype(
        np.float32)).to(T_DT[dt]) for n in (H, K, K))
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=H * hd,
                      n_heads=H, n_kv_heads=K, d_ff=8, vocab=8,
                      dtype=T_DT[dt])
    kernels.reset_launches()
    got = attend(q, k, v)
    assert got.shape == (B, S, H, hd) and got.is_contiguous()
    pos = torch.arange(S).expand(B, S)
    want = _sdpa(q, k, v, make_mask(pos, pos), cfg)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dt],
                               atol=TOL[dt])
    assert kernels.launch_counts()["flash_attention"] == 0


def test_flash_strided_views_keep_layout():
    q, k, v = _port(_qkv(2, 4, 2, 24, 8), "f32")
    want = flash_attention(q, k, v)
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    got = flash_attention(qs, ks, vs)
    assert got.stride() == qs.stride()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_flash_wrapper_runs_plain_on_cpu_without_counting():
    arrays = _port(_qkv(1, 4, 2, 20, 8), "bf16")
    kernels.reset_launches()
    torch.testing.assert_close(flash_attention(*arrays, causal=False),
                               flash_attention_plain(*arrays, causal=False),
                               rtol=0, atol=0)
    assert kernels.launch_counts()["flash_attention"] == 0


def test_flash_wrapper_raises_on_other_devices_and_bad_inputs():
    meta = [torch.empty(s, device="meta") for s in
            ((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16))]
    with pytest.raises(ValueError, match="device"):
        flash_attention(*meta)
    q, k, v = _port(_qkv(1, 4, 2, 8, 16), "f32")
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, k[:, :, :7], v[:, :, :7])
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="B, H, S, hd"):
        flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match=" on "):
        flash_attention(q, k, v.to("meta"))


def test_flash_shared_memory_request():
    """The wrapper's mirror of csrc/flash_attention.cu:smem_floats: at
    qwen3's hd 128 the block needs more than the 48 KB default and fits
    Hopper's opt-in limit; every hd the kernel takes fits."""
    assert smem_bytes(128) == 4 * (64 * 129 + 64 * 129 + 64 * 128) == 98816
    assert smem_bytes(16) == 4 * (64 * 17 + 64 * 65 + 64 * 16)
    assert smem_bytes(128) > build.SMEM_DEFAULT
    assert max(smem_bytes(h) for h in range(8, 129, 8)) <= build.SMEM_OPTIN
    assert build.SOURCES["flash_attention"] == "flash_attention.cu"
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert not re.search(r"__expf\s*\(", src) and "expf(" in src


def test_flash_plain_scale_is_the_oracles():
    """The oracle divides by sqrt(hd) cast to the input dtype: 11.3125 in
    bf16 for hd 128, not 1/sqrt(128) in f32."""
    q = torch.zeros(1, 1, 2, 128, dtype=torch.bfloat16)
    q[0, 0, :, 0] = 1.0
    k = q.clone()
    v = torch.zeros_like(k)
    v[0, 0, 1, 0] = 1.0
    got = flash_attention_plain(q, k, v, causal=False)
    want = j_flash_ref(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                         for x in (q, k, v)), causal=False)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    assert float(torch.tensor(math.sqrt(128)).to(torch.bfloat16)) == 11.3125


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("S", [128, 256])
def test_bf16_matched_version_is_the_pallas_kernels_rounding(S, block_k):
    """chip_smoke.py holds each bf16 route to flash_bf16_matched with its
    own key tile (64 keys on the CUDA-core route, 128 on the sm90 route):
    f32 scores, p rounded to bf16 against the running max of the tiles.
    The Pallas kernel with blocks of the same width rounds the same way,
    so it meets the same limit (2^-7 |want| + 2e-3; its bf16 output alone
    is within 2^-9 |want|), far under the oracle's 3e-2."""
    arrays = _qkv(1, 4, 2, S, 32, seed=6)
    q, k, v = _port(arrays, "bf16")
    want = chip_smoke.flash_bf16_matched(torch, q, k, v, block_k=block_k)
    got = _f32(j_flash(*_jax(arrays, "bf16"), causal=True, block_q=block_k,
                       block_k=block_k, interpret=True))
    atol, rtol = chip_smoke.FLASH_MATCHED_TOL
    diff = np.abs(got - want.numpy())
    assert (diff <= atol + rtol * np.abs(want.numpy())).all(), diff.max()
    assert diff.max() < 1e-2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q0,Sq", [(0, 16), (16, 16), (32, 32), (48, 16),
                                   (5, 27)])
def test_flash_plain_query_offset_is_the_pallas_kernels_rows(q0, Sq, causal):
    """A chunk of Sq queries at q_offset q0 against all 64 keys (one
    device's share of a context-parallel prefill) gives rows [q0, q0 +
    Sq) of the Pallas kernel over the whole sequence (interpret mode), in
    f32 within 1e-5, through the wrapper as through the plain version."""
    S = 64
    arrays = _qkv(2, 8, 2, S, 16, seed=q0 + Sq)
    q, k, v = _port(arrays, "f32")
    chunk = q[:, :, q0:q0 + Sq]
    got = flash_attention_plain(chunk, k, v, causal, q_offset=q0)
    want = _f32(j_flash(*_jax(arrays, "f32"), causal=causal, block_q=16,
                        block_k=16, interpret=True))[:, :, q0:q0 + Sq]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL["f32"],
                               atol=TOL["f32"])
    torch.testing.assert_close(flash_attention(chunk, k, v, causal,
                                               q_offset=q0), got,
                               rtol=0, atol=0)
    # the log-sum-exp rows too, against the whole sequence's
    _, lse = flash_attention_plain(chunk, k, v, causal, True, q0)
    _, lse_all = flash_attention_plain(q, k, v, causal, True)
    np.testing.assert_allclose(lse.numpy(), lse_all[:, :, q0:q0 + Sq].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_flash_query_offset_bounds_and_the_gradient_refuse():
    """q_offset + Sq must not pass Sk; FlashAttention (with a gradient)
    refuses the same offsets, and differentiates at any offset in bounds
    (its backward has the offset form)."""
    from repro_torch.kernels.flash_attention import FlashAttention
    q, k, v = _port(_qkv(1, 4, 2, 32, 8), "f32")
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q[:, :, :16], k, v, q_offset=17)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=1)
    qg = q[:, :, :16].clone().requires_grad_()
    with pytest.raises(ValueError, match="q_offset"):
        FlashAttention.apply(qg, k, v, True, 17)
    with pytest.raises(ValueError, match="q_offset"):
        FlashAttention.apply(q.clone().requires_grad_(), k, v, True, 1)
    FlashAttention.apply(qg, k, v, True, 16).sum().backward()
    assert qg.grad is not None and qg.grad.shape == qg.shape


@pytest.mark.parametrize("dt,hd", [("bf16", 128), ("f32", 128), ("bf16", 32)])
def test_dry_run_counts_the_offset_chunks_tiles(dt, hd):
    """A context-parallel chunk's visited tiles, as the kernels step them
    (analysis/op_count.py through the shape-only op): the diagonal moves
    by the offset, so a chunk at q_offset o of Sk keys visits the key
    tiles up to its last row's position; the chunks of a sequence visit
    what its whole call visits where the chunks are whole tiles."""
    from repro_torch.analysis import op_count
    from repro_torch.kernels import flash_attention as fa
    B, H, K, S, n = 1, 8, 2, 512, 4
    dtype = T_DT[dt]
    b = fa.SM90_BLOCK_Q if fa.route(dtype, hd) == "sm90" else fa.BLOCK_Q

    def meta(s):
        return torch.empty(B, H if s != S else K, s, hd, device="meta",
                           dtype=dtype)

    Sq = S // n
    total = 0
    for g in range(n):
        _, c = op_count.count(lambda: fa.flash_attention(
            meta(Sq), meta(S), meta(S), q_offset=g * Sq))
        tiles = sum(min(-(-S // b), ((u + 1) * b + g * Sq - 1) // b + 1)
                    for u in range(-(-Sq // b)))
        assert c["flops"] == 4 * hd * B * H * tiles * b * b \
            == fa.kernel_flops(B, H, Sq, hd, dtype, True, S, g * Sq)
        total += c["flops"]
    assert total == fa.kernel_flops(B, H, S, hd, dtype, True)
    _, c = op_count.count(lambda: fa.flash_attention(
        meta(Sq), meta(S), meta(S), causal=False, q_offset=Sq))
    assert c["flops"] == 4 * hd * B * H * (Sq // b) * (S // b) * b * b
