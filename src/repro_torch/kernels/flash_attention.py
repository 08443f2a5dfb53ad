"""Flash attention for LM prefill and training: GQA, causal or not,
forward and backward.

  * ``flash_attention(q, k, v, causal=True, q_offset=0)`` -- q (B, H,
    Sq, hd), k and v (B, K, Sk, hd) with H = K * rep; query head h reads
    KV head h // rep. Scale 1/sqrt(hd), f32 scores, a running max and sum
    and an f32 accumulator; p is cast to v's dtype before the P.V
    product; output acc / max(l, 1e-30) in q's dtype. f32 or bf16; hd <=
    128 and a multiple of 8; any lengths (the ragged last tiles are
    masked). The queries sit at key positions q_offset .. q_offset + Sq
    - 1 (q_offset + Sq <= Sk): causal, query i sees key j iff j <=
    q_offset + i; a whole sequence is q_offset 0 with Sq = Sk, and a
    context-parallel prefill hands each device its chunk of queries at
    the chunk's start against the whole sequence's keys. Replaces the TPU
    kernel repro/kernels/flash_attention.py:86.
  * ``flash_attention_bwd(q, k, v, out, dout, lse, causal=True,
    q_offset=0)`` -- its gradient (dq, dk, dv) from the forward's output
    and log-sum-exp, on the route ``route`` picks as for the forward, at
    the same query offset: a chunk's dK and dV are its share of the whole
    sequence's (the chunks' shares sum to it), exactly zero at every key
    that no query of the chunk sees. The JAX package has no Pallas
    backward; the reference's gradient is repro/models/attention.py:359
    (_flash_bwd), whose steps ``flash_attention_bwd_plain`` repeats.
  * ``FlashAttention`` -- the autograd Function training takes: its
    forward launches a forward route with the LSE output and saves q, k,
    v, out and lse; its backward launches the backward kernel, both at
    the call's ``q_offset`` (a context-parallel step's chunk).

The inputs may be strided views (the last dimension unit-stride): LM
prefill hands it the (B, S, H, hd) projections transposed, with no
copy, and the output takes q's layout (``torch.empty_like``).

Two CUDA routes compute each direction; ``route(dtype, hd)`` picks one,
a plain function of the two and nothing else:

  * ``"sm90"`` for bf16 at hd 16, 64 or 128: every product on the tensor
    cores (wgmma), tiles fed through TMA rings. The forward
    (csrc/flash_attention_sm90.cu) takes one thread block per (b*h,
    128-query tile); the backward (csrc/flash_attention_bwd_sm90.cu) a
    delta kernel, a dK/dV kernel per (b, KV head, head group, 128-key
    tile), a dQ kernel per (b*h, 128-query tile) beside it on a second
    stream, and where the heads are split a kernel that sums the groups
    (``bwd_plan_sm90``). TMA reads
    through tensor maps, so every stride but the last and every base
    address must be a multiple of 16 bytes; the wrappers raise on any
    other layout rather than copy.
  * ``"cuda_core"`` (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu)
    for everything else, f32 above all: every product on CUDA cores in
    f32, 64-row tiles. f32 stays off the tensor cores: TF32 would break
    its 1e-5 checks.

Bound on the H100: at qwen3-14b's prefill widths (H 40, K 8, hd 128,
bf16) bytes for B 4 x S 512 (50.3 MB, 15 us), operations for B 1 x
S 2048 (causal, 42.9 GFLOP, 43 us at the bf16 tensor-core rate). Each
route's shared-memory request is mirrored here (``smem_bytes``,
``smem_bytes_sm90``, ``bwd_smem_bytes``, ``bwd_smem_bytes_sm90``); the
CUDA-core routes check theirs against ``build.SMEM_OPTIN`` per call, the
tests the sm90 routes' at every hd they are built for.

Both forward routes write each row's log-sum-exp m + log(max(l,
1e-30)) (f32 (B, H, S), as repro/models/attention.py:348 computes it)
only when asked (``lse=True``, training); serving passes no buffer and
the kernels write nothing more.

``flash_attention`` launches the route's kernel for CUDA tensors and
runs the plain version ``flash_attention_plain`` (the counterpart of
repro/kernels/ref.py:flash_attention_ref) for CPU tensors; nothing else.
Inside ``shape_only()`` (launch/dryrun.py's traces), meta tensors go
through the shape-only ops ``torch.ops.repro_torch.flash_attention_fwd``
/ ``_bwd``, one op a call, so a dispatch mode sees the call's operands
and results and ``analysis/op_count.py`` counts the tiles the route's
kernels compute (``kernel_flops``, ``kernel_bwd_flops``); anywhere else a
meta tensor raises, as every wrapper's does.
``flash_attention_bwd`` likewise launches its route's kernels or runs
``flash_attention_bwd_plain``; neither falls back from one route to the
other. ``flash_attention.launches`` counts kernel launches of both
forward routes, ``flash_attention.route_launches`` each route's;
``flash_attention_bwd.launches`` and ``.route_launches`` the backward's
(one a call: delta, dK/dV and dQ, and on sm90 the groups' sum where the
heads are split).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import math
from typing import Tuple

import torch

from . import build

Tensor = torch.Tensor

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_Q = BLOCK_K = 64          # csrc/flash_attention.cu: BQ, BK
MAX_HD = 128
# csrc/flash_attention_sm90.cu: BQ, BK, STAGES and the hd it is built for
SM90_BLOCK_Q = SM90_BLOCK_K = 128
SM90_STAGES = 2
SM90_HD = (16, 64, 128)
ROUTES = ("sm90", "cuda_core")
# csrc/flash_attention_bwd_sm90.cu: keys per dK/dV block (BKV) and
# queries per its ring step (BQ), queries per dQ block (DQ_BQ) and keys
# per its ring step (DQ_BK), the rings' STAGES, and the rows its (lse,
# delta) scratch is padded to (PAD)
SM90_BWD_BLOCK_KV = 128
SM90_BWD_BLOCK_Q = 64
SM90_BWD_DQ_BLOCK_Q = SM90_BWD_DQ_BLOCK_K = 128
SM90_BWD_STAGES = 2
SM90_BWD_PAD = 128
# a score's work in a dQ block against one in a dK/dV block, in the
# plan's balance: the same exponential and ds, 3 of the 4 products
SM90_BWD_DQ_WORK = 0.75

# q, k, v, o, lse; B, H, K, Sq, Sk, q_offset, hd, causal[, bf16]; the
# strides; the stream
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 9
             + (ctypes.c_longlong,) * 9 + (ctypes.c_void_p,))
_SM90_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 8
                  + (ctypes.c_longlong,) * 12 + (ctypes.c_void_p,))
# q, k, v, o, dout, lse, delta, dq, dk, dv; B, H, K, Sq, Sk, q_offset,
# hd, causal, bf16; the 24 strides; the stream
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 9
                 + (ctypes.c_void_p,) * 2)
# q, k, v, o, dout, lse, the (lse, delta) pairs, the head groups' f32
# partials, dq, dk, dv; B, H, K, Sq, Sk, q_offset, hd, causal, groups; the
# strides; the stream
_BWD_SM90_ARGTYPES = ((ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 9
                      + (ctypes.c_void_p,) * 2)


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a CUDA call takes: "sm90" for bf16 at hd 16, 64 or 128,
    "cuda_core" for anything else."""
    return "sm90" if dtype == torch.bfloat16 and hd in SM90_HD \
        else "cuda_core"


def smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one thread block of the CUDA-core route:
    f32 Q and K tiles with rows padded to hd + 1, the P tile (BK + 1 per
    row) in the K tile's space, a V tile of hd
    (csrc/flash_attention.cu:smem_floats)."""
    kp = max(BLOCK_K * (hd + 1), BLOCK_Q * (BLOCK_K + 1))
    return 4 * (BLOCK_Q * (hd + 1) + kp + BLOCK_K * hd)


def bwd_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one thread block of the backward's dK/dV
    and dQ kernels: four f32 tiles of 64 rows padded to hd + 1, the
    64 x 65 w / ds tile, 64 lse and 64 delta values
    (csrc/flash_attention_bwd.cu:smem_floats)."""
    return 4 * (4 * 64 * (hd + 1) + 64 * (BLOCK_Q + 1) + 2 * 64)


def smem_bytes_sm90(hd: int) -> int:
    """Dynamic shared memory of one thread block of the sm90 route: 1,024
    bytes of alignment slack, the bf16 Q tile, STAGES K and V tiles, and
    8 bytes per mbarrier (Q, and full and empty per stage)
    (csrc/flash_attention_sm90.cu:Geo::SMEM)."""
    tiles = SM90_BLOCK_Q + 2 * SM90_STAGES * SM90_BLOCK_K
    return 1024 + 2 * hd * tiles + 8 * (1 + 2 * SM90_STAGES)


def bwd_smem_bytes_sm90(hd: int) -> tuple:
    """Dynamic shared memory of one thread block of the sm90 backward's
    dK/dV and dQ kernels (csrc/flash_attention_bwd_sm90.cu:KvGeo::SMEM,
    QGeo::SMEM): 1,024 bytes of alignment slack; the bf16 K and V tiles,
    STAGES Q and do tiles and their (lse, delta) pairs (8 bytes a query)
    and 8 bytes per mbarrier (K/V, and full and empty per stage); or the
    bf16 Q and do tiles, STAGES K and V tiles and their barriers."""
    st, bars = SM90_BWD_STAGES, 8 * (1 + 2 * SM90_BWD_STAGES)
    dkdv = (1024 + 2 * hd * (2 * SM90_BWD_BLOCK_KV
                             + 2 * st * SM90_BWD_BLOCK_Q)
            + st * SM90_BWD_BLOCK_Q * 8 + bars)
    dq = (1024 + 2 * hd * (2 * SM90_BWD_DQ_BLOCK_Q
                           + 2 * st * SM90_BWD_DQ_BLOCK_K) + bars)
    return dkdv, dq


@functools.lru_cache(maxsize=256)
def bwd_plan_sm90(B: int, H: int, K: int, S: int, causal: bool,
                  sms: int, Sk: int = None, q_offset: int = 0) -> dict:
    """The sm90 backward's launch at (B, H, K, S) on a card of ``sms``
    SMs (the same at every hd), S queries at key positions ``q_offset``
    on against ``Sk`` keys (S by default): two kernels side by side that
    the card runs one block an SM, in index order, the dK/dV kernel
    first: B x K x ``groups`` head groups x 128-key tiles, each stepping
    over its group's query heads' 64-query tiles (from the diagonal on
    when causal: none for a key tile past the chunk's last query); the dQ
    kernel: B x H x 128-query tiles, each over its 128-key tiles up to the
    diagonal. A chunk's key tiles up to its offset step over every query
    tile, so its work a key tile is uneven as a whole sequence's is.

    ``groups`` splits each KV head's rep query heads (csrc:dkdv_block):
    the fewest groups whose longest dK/dV block is no longer than the
    mean work an SM (dK/dV steps, and dQ steps weighed by their scores
    and SM90_BWD_DQ_WORK, over ``sms``), else rep. A causal key tile 0
    steps over every query tile of every head of its group, 2 S / 128
    times the last tile's work: with one group at B 1 x S 2,048 it alone
    outlasts the mean. More than one group writes f32 partials that a
    fourth kernel sums in group order. Per kernel: blocks, waves (blocks
    over SMs), ring steps of the longest and of the mean block."""
    rep = H // K
    Sk = S if Sk is None else Sk
    nq = -(-S // SM90_BWD_BLOCK_Q)
    tiles = [max(nq - (max(t * SM90_BWD_BLOCK_KV - q_offset, 0)
                       // SM90_BWD_BLOCK_Q if causal else 0), 0)
             for t in range(-(-Sk // SM90_BWD_BLOCK_KV))]
    nk = -(-Sk // SM90_BWD_DQ_BLOCK_K)
    q = [min(nk, (q_offset + (u + 1) * SM90_BWD_DQ_BLOCK_Q - 1)
             // SM90_BWD_DQ_BLOCK_K + 1) if causal else nk
         for u in range(-(-S // SM90_BWD_DQ_BLOCK_Q))]
    dq_step = SM90_BWD_DQ_WORK * SM90_BWD_DQ_BLOCK_Q * SM90_BWD_DQ_BLOCK_K \
        / (SM90_BWD_BLOCK_KV * SM90_BWD_BLOCK_Q)
    load = B * H * (sum(tiles) + dq_step * sum(q)) / sms
    groups = next((g for g in range(1, rep) if -(-rep // g) * max(tiles)
                   <= load), rep)
    kv = [n * (rep // groups + (g < rep % groups)) for n in tiles
          for g in range(groups)]
    out = {"groups": groups}
    for name, steps, per in (("dkdv", kv, B * K), ("dq", q, B * H)):
        blocks = per * len(steps)
        out[name] = {"blocks": blocks, "waves": blocks / sms,
                     "blocks_per_sm": 1, "longest_steps": max(steps),
                     "mean_steps": sum(steps) / len(steps)}
    out["dkdv"]["tile"] = (SM90_BWD_BLOCK_KV, SM90_BWD_BLOCK_Q)
    out["dq"]["tile"] = (SM90_BWD_DQ_BLOCK_Q, SM90_BWD_DQ_BLOCK_K)
    return out


def _tile_pairs(S: int, bq: int, bk: int, causal: bool,
                keys_outer: bool = False, Sk: int = None,
                q_offset: int = 0) -> int:
    """The (query, key) scores one (b, h) computes over its tiles of bq
    queries by bk keys, S queries against ``Sk`` keys (S by default),
    the queries at key positions ``q_offset`` on: every tile, or, causal,
    the tiles a kernel visits -- a query tile's key tiles up to its last
    row's position (``keys_outer``: a key tile's query tiles from the one
    that holds its first key's position on, as the backward's dK/dV
    kernels step; none for a key tile past the last query)."""
    Sk = S if Sk is None else Sk
    nq, nk = -(-S // bq), -(-Sk // bk)
    if not causal:
        return nq * nk * bq * bk
    if keys_outer:
        return sum(max(nq - max(t * bk - q_offset, 0) // bq, 0)
                   for t in range(nk)) * bq * bk
    return sum(min(nk, ((u + 1) * bq + q_offset - 1) // bk + 1)
               for u in range(nq)) * bq * bk


def kernel_flops(B: int, H: int, S: int, hd: int, dtype: torch.dtype,
                 causal: bool, Sk: int = None, q_offset: int = 0) -> int:
    """Operations the forward route for ``dtype`` and ``hd`` computes: two
    products (S = Q K^T, P V), 2 hd each, over every score of its visited
    tiles (128 x 128 on sm90, 64 x 64 on cuda_core); S queries at
    ``q_offset`` against ``Sk`` keys (S by default)."""
    b = SM90_BLOCK_Q if route(dtype, hd) == "sm90" else BLOCK_Q
    return 4 * hd * B * H * _tile_pairs(S, b, b, causal, Sk=Sk,
                                        q_offset=q_offset)


def kernel_bwd_flops(B: int, H: int, S: int, hd: int, dtype: torch.dtype,
                     causal: bool, Sk: int = None, q_offset: int = 0) -> int:
    """Operations the backward route computes: the dK/dV kernel's four
    products (S, dP, dV, dK) over its tiles (128 keys by 64-query steps
    on sm90, 64 x 64 on cuda_core) and the dQ kernel's three (S, dP, dQ)
    over its (128 x 128 or 64 x 64), 2 hd each; S queries at
    ``q_offset`` against ``Sk`` keys (S by default)."""
    at = {"Sk": Sk, "q_offset": q_offset}
    if route(dtype, hd) == "sm90":
        kv = _tile_pairs(S, SM90_BWD_BLOCK_Q, SM90_BWD_BLOCK_KV, causal,
                         keys_outer=True, **at)
        dq = _tile_pairs(S, SM90_BWD_DQ_BLOCK_Q, SM90_BWD_DQ_BLOCK_K, causal,
                         **at)
    else:
        kv = _tile_pairs(S, BLOCK_Q, BLOCK_K, causal, keys_outer=True, **at)
        dq = _tile_pairs(S, BLOCK_Q, BLOCK_K, causal, **at)
    return 2 * hd * B * H * (4 * kv + 3 * dq)


_SHAPE_ONLY = contextvars.ContextVar("flash_shape_only", default=False)


@contextlib.contextmanager
def shape_only():
    """Within the block the wrappers take meta tensors, one shape-only op
    a call (the dry run's traces)."""
    token = _SHAPE_ONLY.set(True)
    try:
        yield
    finally:
        _SHAPE_ONLY.reset(token)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _meta_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool,
              lse: bool, q_offset: int = 0) -> Tuple[Tensor, Tensor]:
    raise ValueError("repro_torch::flash_attention_fwd is shape-only: it "
                     "takes meta tensors (the dry run's traces)")


@_meta_fwd.register_fake
def _(q, k, v, causal, lse, q_offset=0):
    B, H, S, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, S) if lse else (0,),
                                            dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _meta_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor, dout: Tensor,
              lse: Tensor, causal: bool, q_offset: int = 0
              ) -> Tuple[Tensor, Tensor, Tensor]:
    raise ValueError("repro_torch::flash_attention_bwd is shape-only: it "
                     "takes meta tensors (the dry run's traces)")


@_meta_bwd.register_fake
def _(q, k, v, out, dout, lse, causal, q_offset=0):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _tma_problem(t: Tensor):
    """Why a TMA tensor map cannot describe ``t``'s layout, or None: a
    last dimension that is not unit-stride, a base address or a stride
    that is not a multiple of 16 bytes. A dimension of size 1 is never
    stepped, so its stride is taken as hd."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return ("the last dimension must be unit-stride and the base "
                "16-byte aligned")
    out = [t.stride(d) if t.shape[d] > 1 else t.shape[-1] for d in range(3)]
    if any(s <= 0 or s * t.element_size() % 16 for s in out):
        return f"strides {t.stride()} are not all multiples of 16 bytes"
    return None


def tma_strides(t: Tensor) -> list:
    """Element strides of dims B, heads and S of a bf16 input, as its TMA
    tensor map takes them; raises ValueError where a map cannot describe
    the layout (``_tma_problem``)."""
    problem = _tma_problem(t)
    if problem is not None:
        raise ValueError(f"flash_attention (sm90 route): {problem}")
    return [t.stride(d) if t.shape[d] > 1 else t.shape[-1] for d in range(3)]


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                          causal: bool = True, lse: bool = False,
                          q_offset: int = 0):
    """The same function in plain tensor ops, on any device, as the
    reference's oracle computes it: scores in the input dtype divided by
    sqrt(hd) in that dtype, masked to -1e30 (causal: key j of query i iff
    j <= q_offset + i), softmax in f32, the weights cast back before the
    P.V product. With ``lse`` -> (out, each row's log-sum-exp (B, H, Sq)
    f32): m + log(max(l, 1e-30)) of the f32 scores of the inputs times
    the f32 1/sqrt(hd), as the kernels and the reference's
    _flash_fwd_impl take them."""
    B, H, S, hd = q.shape
    Sk = k.shape[2]
    rep = H // k.shape[1]
    kk = k.repeat_interleave(rep, dim=1)
    vv = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) / _rounded(math.sqrt(hd),
                                                          q.dtype)
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device).tril(
        q_offset) if causal else None
    if mask is not None:
        s = s.masked_fill(~mask, -1e30)
    w = torch.softmax(s.to(torch.float32), -1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", w, vv)
    if not lse:
        return out
    s32 = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) \
        * _rounded(1.0 / math.sqrt(hd), torch.float32)
    if mask is not None:
        s32 = s32.masked_fill(~mask, -1e30)
    m = s32.amax(-1)
    l = torch.exp(s32 - m[..., None]).sum(-1)
    return out, m + torch.log(torch.clamp(l, min=1e-30))


def flash_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, dout: Tensor,
                              lse: Tensor, causal: bool = True,
                              q_offset: int = 0):
    """The gradient (dq, dk, dv) of the forward at the output gradient
    ``dout`` (q's shape) from its log-sum-exp ``lse`` (B, H, Sq), in plain
    tensor ops, step for step as the reference's _flash_bwd
    (repro/models/attention.py:359): f32 scores of the inputs times
    hd^-0.5, masked to -1e9 (causal: key j of query i iff j <= q_offset +
    i, the reference's make_mask over the chunk's rows); w = exp(s - lse)
    cast to v's dtype; dv = w^T dout and dw = dout v^T in the inputs'
    dtype; delta = rowsum(dw * w) in f32; ds = w * (dw - delta) * hd^-0.5
    cast to q's dtype; dq = ds k, dk = ds^T q; dk and dv summed over each
    KV head's rep query heads. The queries sit at key positions
    ``q_offset`` on against k's Sk keys: a key no query sees has w = 0
    and gets zero dk and dv."""
    B, H, S, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    rep = H // K
    scale = hd ** -0.5
    q5 = q.reshape(B, K, rep, S, hd)
    do5 = dout.reshape(B, K, rep, S, hd)
    s = torch.einsum("bkrqd,bksd->bkrqs", q5.float(), k.float()) * scale
    if causal:
        mask = torch.ones((S, Sk), dtype=torch.bool,
                          device=q.device).tril(q_offset)
        s = s.masked_fill(~mask, -1e9)
    w = torch.exp(s - lse.reshape(B, K, rep, S, 1)).to(v.dtype)
    dv = torch.einsum("bkrqs,bkrqd->bksd", w, do5)
    dw = torch.einsum("bkrqd,bksd->bkrqs", do5, v)
    delta = (dw.float() * w.float()).sum(-1)
    ds = (w.float() * (dw.float() - delta[..., None]) * scale).to(q.dtype)
    dq = torch.einsum("bkrqs,bksd->bkrqd", ds, k).reshape(B, H, S, hd)
    dk = torch.einsum("bkrqs,bkrqd->bksd", ds, q5)
    return dq, dk, dv


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` through f32 (as the reference's
    ``jnp.sqrt(hd).astype(dtype)``), as a Python float: a tensor built on
    the card would cost a synchronizing host-to-device copy."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


def _check(q: Tensor, k: Tensor, v: Tensor, q_offset: int = 0) -> None:
    """ValueError unless q (B, H, Sq, hd) and k, v (B, K, Sk, hd) fit:
    q_offset + Sq <= Sk."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, H, S, hd) and k, v "
                         f"(B, K, S, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    if (k.shape[0], k.shape[3]) != (B, hd) or k.shape[1] == 0 \
            or H % k.shape[1] or q_offset < 0 \
            or q_offset + S > k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} at q_offset {q_offset} "
                         f"(H a multiple of K; q_offset + Sq <= Sk)")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention takes three f32 or three bf16 "
                         f"inputs, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"flash_attention inputs on {q.device}, "
                         f"{k.device} and {v.device}")


def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                    causal: bool = True, lse: bool = False,
                    q_offset: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, K, Sk, hd), H % K == 0, the queries at
    key positions ``q_offset`` on (q_offset + Sq <= Sk; Sk = Sq where
    q_offset is 0) -> (B, H, Sq, hd) in q's dtype and layout; with
    ``lse`` -> (out, the rows' log-sum-exp (B, H, Sq) f32)."""
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    if q.device.type == "cpu":
        res = flash_attention_plain(q, k, v, causal, lse, q_offset)
        out = torch.empty_like(q)
        if not lse:
            return out.copy_(res)
        return out.copy_(res[0]), res[1]
    if q.device.type == "meta" and _SHAPE_ONLY.get():
        out, buf = _meta_fwd(q, k, v, bool(causal), bool(lse), q_offset)
        return (out, buf) if lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if route(q.dtype, q.shape[-1]) == "sm90":
        return launch_sm90(q, k, v, causal, lse, q_offset)
    return launch_cuda_core(q, k, v, causal, lse, q_offset)


def _lse_buffer(q: Tensor, want: bool):
    """The f32 (B, H, S) LSE output when asked, else None, and the pointer
    the kernel takes (0: write none)."""
    if not want:
        return None, 0
    B, H, S, _ = q.shape
    buf = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    return buf, buf.data_ptr()


def launch_cuda_core(q: Tensor, k: Tensor, v: Tensor,
                     causal: bool = True, lse: bool = False,
                     q_offset: int = 0):
    """The CUDA-core kernel (csrc/flash_attention.cu) on CUDA tensors."""
    _check(q, k, v, q_offset)
    B, H, S, hd = q.shape
    if hd > MAX_HD or hd % 8:
        raise ValueError(f"the CUDA kernel takes hd <= {MAX_HD}, a multiple "
                         f"of 8; got {hd}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or k.stride() != v.stride():
        raise ValueError("flash_attention: the last dimension must be "
                         "unit-stride and k, v must share strides")
    if smem_bytes(hd) > build.SMEM_OPTIN:
        raise ValueError(f"hd {hd} needs {smem_bytes(hd)} bytes of shared "
                         f"memory, over {build.SMEM_OPTIN}")
    out = torch.empty_like(q)
    buf, ptr = _lse_buffer(q, lse)
    if out.numel() == 0:
        return (out, buf) if lse else out
    build.launch("flash_attention", _ARGTYPES, q, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr, B, H,
                 k.shape[1], S, k.shape[2], q_offset, hd, int(causal),
                 _DTYPE_CODES[q.dtype],
                 *q.stride()[:3], *k.stride()[:3], *out.stride()[:3])
    _count("cuda_core")
    return (out, buf) if lse else out


def launch_sm90(q: Tensor, k: Tensor, v: Tensor,
                causal: bool = True, lse: bool = False, q_offset: int = 0):
    """The tensor-core kernel (csrc/flash_attention_sm90.cu) on bf16 CUDA
    tensors at hd 16, 64 or 128, read through TMA maps."""
    _check(q, k, v, q_offset)
    B, H, S, hd = q.shape
    if q.dtype != torch.bfloat16 or hd not in SM90_HD:
        raise ValueError(f"the sm90 kernel takes bf16 at hd {SM90_HD}; got "
                         f"{q.dtype} at hd {hd}")
    out = torch.empty_like(q)
    buf, ptr = _lse_buffer(q, lse)
    if out.numel() == 0:
        return (out, buf) if lse else out
    strides = [s for t in (q, k, v) for s in tma_strides(t)]
    build.launch("flash_attention_sm90", _SM90_ARGTYPES, q, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr, B, H,
                 k.shape[1], S, k.shape[2], q_offset, hd, int(causal),
                 *strides,
                 *out.stride()[:3])
    _count("sm90")
    return (out, buf) if lse else out


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                        dout: Tensor, lse: Tensor, causal: bool = True,
                        q_offset: int = 0):
    """The gradient (dq, dk, dv) of ``flash_attention(q, k, v, causal,
    q_offset=q_offset)`` at the output gradient ``dout``, from its output
    ``out`` and log-sum-exp ``lse`` (B, H, Sq) f32; each in its input's
    dtype and layout. CUDA tensors launch the kernels of
    ``route(q.dtype, hd)``; CPU tensors run ``flash_attention_bwd_plain``
    (which reads no ``out``)."""
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    B, H, S, hd = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} on {t.device} is "
                             f"not q's {tuple(q.shape)} {q.dtype} on "
                             f"{q.device}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be f32 {(B, H, S)} "
                         f"on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, lse, causal,
                                         q_offset)
    if q.device.type == "meta" and _SHAPE_ONLY.get():
        return _meta_bwd(q, k, v, out, dout, lse, bool(causal), q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    if route(q.dtype, hd) == "sm90":
        return launch_bwd_sm90(q, k, v, out, dout, lse, causal, q_offset)
    return launch_bwd_cuda_core(q, k, v, out, dout, lse, causal, q_offset)


def launch_bwd_cuda_core(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                         dout: Tensor, lse: Tensor, causal: bool = True,
                         q_offset: int = 0):
    """The CUDA-core backward (csrc/flash_attention_bwd.cu) on CUDA
    tensors, f32 or bf16 at any hd <= 128 a multiple of 8."""
    _check(q, k, v, q_offset)
    B, H, S, hd = q.shape
    if hd > MAX_HD or hd % 8:
        raise ValueError(f"the backward kernel takes hd <= {MAX_HD}, a "
                         f"multiple of 8; got {hd}")
    tensors = (q, k, v, out, dout)
    if any(t.stride(-1) != 1 for t in tensors) or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: the last dimension must be "
                         "unit-stride and lse contiguous")
    if bwd_smem_bytes(hd) > build.SMEM_OPTIN:
        raise ValueError(f"hd {hd} needs {bwd_smem_bytes(hd)} bytes of "
                         f"shared memory, over {build.SMEM_OPTIN}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*[
        s for t in tensors + (dq, dk, dv) for s in t.stride()[:3]])
    build.launch("flash_attention_bwd", _BWD_ARGTYPES, q,
                 *(t.data_ptr() for t in tensors), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, H, k.shape[1], S, k.shape[2], q_offset,
                 hd, int(causal), _DTYPE_CODES[q.dtype],
                 ctypes.addressof(strides))
    _count_bwd("cuda_core")
    return dq, dk, dv


def launch_bwd_sm90(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                    dout: Tensor, lse: Tensor, causal: bool = True,
                    q_offset: int = 0):
    """The tensor-core backward (csrc/flash_attention_bwd_sm90.cu) on bf16
    CUDA tensors at hd 16, 64 or 128; q, k, v, out and dout read through
    TMA maps (``tma_strides`` raises on a layout they cannot describe),
    dq, dk and dv written in q's, k's and v's layouts."""
    _check(q, k, v, q_offset)
    B, H, S, hd = q.shape
    if q.dtype != torch.bfloat16 or hd not in SM90_HD:
        raise ValueError(f"the sm90 backward takes bf16 at hd {SM90_HD}; "
                         f"got {q.dtype} at hd {hd}")
    if not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous")
    tensors = (q, k, v, out, dout)
    for t in tensors:
        tma_strides(t)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    K, Sk = k.shape[1], k.shape[2]
    groups = bwd_plan_sm90(B, H, K, S, bool(causal),
                           build.sm_count(q.device.index), Sk,
                           q_offset)["groups"]
    pad = -(-S // SM90_BWD_PAD) * SM90_BWD_PAD
    pairs = torch.empty((B, H, pad, 2), dtype=torch.float32, device=q.device)
    part = torch.empty((2, groups, B, K, Sk, hd) if groups > 1 else (0,),
                       dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*[
        s for t in tensors + (dq, dk, dv) for s in t.stride()[:3]])
    build.launch("flash_attention_bwd_sm90", _BWD_SM90_ARGTYPES, q,
                 *(t.data_ptr() for t in tensors), lse.data_ptr(),
                 pairs.data_ptr(), part.data_ptr() if groups > 1 else None,
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, K, S,
                 Sk, q_offset, hd, int(causal), groups,
                 ctypes.addressof(strides))
    _count_bwd("sm90")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward launches the
    route's kernel with the LSE output and saves q, k, v, out and lse; the
    backward launches ``flash_attention_bwd``'s kernel (the plain versions
    for CPU tensors), both at ``q_offset``.
    ``FlashAttention.apply(q, k, v, causal, q_offset)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, q_offset=0):
        out, lse = flash_attention(q, k, v, causal, lse=True,
                                   q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, int(q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # a fresh contiguous copy where the sm90 route's tensor map cannot
        # read dout (a view of an aligned buffer may itself be misaligned)
        if route(q.dtype, q.shape[-1]) == "sm90" \
                and _tma_problem(dout) is not None:
            dout = dout.clone(memory_format=torch.contiguous_format)
        elif dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, ctx.causal,
                                         ctx.q_offset)
        return dq, dk, dv, None, None


def _count(name: str) -> None:
    flash_attention.launches += 1
    flash_attention.route_launches[name] += 1


def _count_bwd(name: str) -> None:
    flash_attention_bwd.launches += 1
    flash_attention_bwd.route_launches[name] += 1


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = dict.fromkeys(ROUTES, 0)
