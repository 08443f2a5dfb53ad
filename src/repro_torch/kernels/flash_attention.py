"""Flash attention (forward) for LM prefill: GQA, causal or not.

  * ``flash_attention(q, k, v, causal=True)`` -- q (B, H, S, hd), k and v
    (B, K, S, hd) with H = K * rep; query head h reads KV head h // rep.
    Scale 1/sqrt(hd), f32 scores, a running max and sum and an f32
    accumulator; p is cast to v's dtype before the P.V product; output
    acc / max(l, 1e-30) in q's dtype. f32 or bf16; hd <= 128 and a
    multiple of 8; any S (the ragged last tile is masked). Replaces the
    TPU kernel repro/kernels/flash_attention.py:86.

The inputs may be strided views (the last dimension unit-stride): LM
prefill hands it the (B, S, H, hd) projections transposed, with no
copy, and the output takes q's layout (``torch.empty_like``).

Two CUDA kernels compute it; ``route(dtype, hd)`` picks one, a plain
function of the two and nothing else:

  * ``"sm90"`` (csrc/flash_attention_sm90.cu) for bf16 at hd 16, 64 or
    128: both products on the tensor cores (wgmma), K and V fed through
    a TMA ring, one thread block per (b*h, 128-query tile). TMA reads
    through tensor maps, so every stride but the last and every base
    address must be a multiple of 16 bytes; the wrapper raises on any
    other layout rather than copy.
  * ``"cuda_core"`` (csrc/flash_attention.cu) for everything else, f32
    above all: both products on CUDA cores in f32, one thread block per
    (b*h, 64-query tile). f32 stays off the tensor cores: TF32 would
    break its 1e-5 checks.

Bound on the H100: at qwen3-14b's prefill widths (H 40, K 8, hd 128,
bf16) bytes for B 4 x S 512 (50.3 MB, 15 us), operations for B 1 x
S 2048 (causal, 42.9 GFLOP, 43 us at the bf16 tensor-core rate). Each
route's shared-memory request is mirrored here (``smem_bytes``,
``smem_bytes_sm90``); the CUDA-core route checks its own against
``build.SMEM_OPTIN`` per call, the tests the sm90 route's at every hd it
is built for.

``flash_attention`` launches the route's kernel for CUDA tensors and
runs the plain version ``flash_attention_plain`` (the counterpart of
repro/kernels/ref.py:flash_attention_ref) for CPU tensors; nothing else.
``flash_attention.launches`` counts kernel launches of both routes,
``flash_attention.route_launches`` each route's.
"""
from __future__ import annotations

import ctypes
import math

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

_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7
             + (ctypes.c_longlong,) * 9 + (ctypes.c_void_p,))
_SM90_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
                  + (ctypes.c_longlong,) * 12 + (ctypes.c_void_p,))


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


def smem_bytes_sm90(hd: int) -> int:
    """Dynamic shared memory of one thread block of the sm90 route: 1,024
    bytes of alignment slack, the bf16 Q tile, STAGES K and V tiles, and
    8 bytes per mbarrier (Q, and full and empty per stage)
    (csrc/flash_attention_sm90.cu:Geo::SMEM)."""
    tiles = SM90_BLOCK_Q + 2 * SM90_STAGES * SM90_BLOCK_K
    return 1024 + 2 * hd * tiles + 8 * (1 + 2 * SM90_STAGES)


def tma_strides(t: Tensor) -> list:
    """Element strides of dims B, heads and S of a bf16 input, as its TMA
    tensor map takes them; raises ValueError where a map cannot describe
    the layout: a base address or a stride that is not a multiple of 16
    bytes, or a last dimension that is not unit-stride. A dimension of
    size 1 is never stepped, so its stride is given as hd."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        raise ValueError("flash_attention (sm90 route): the last dimension "
                         "must be unit-stride and the base 16-byte aligned")
    out = [t.stride(d) if t.shape[d] > 1 else t.shape[-1] for d in range(3)]
    if any(s <= 0 or s * t.element_size() % 16 for s in out):
        raise ValueError(f"flash_attention (sm90 route): strides "
                         f"{t.stride()} are not all multiples of 16 bytes")
    return out


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                          causal: bool = True) -> Tensor:
    """The same function in plain tensor ops, on any device, as the
    reference's oracle computes it: scores in the input dtype divided by
    sqrt(hd) in that dtype, masked to -1e30, softmax in f32, the weights
    cast back before the P.V product."""
    B, H, S, hd = q.shape
    rep = H // k.shape[1]
    kk = k.repeat_interleave(rep, dim=1)
    vv = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) / _rounded(math.sqrt(hd),
                                                          q.dtype)
    if causal:
        m = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~m, -1e30)
    w = torch.softmax(s.to(torch.float32), -1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv)


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` through f32 (as the reference's
    ``jnp.sqrt(hd).astype(dtype)``), as a Python float: a tensor built on
    the card would cost a synchronizing host-to-device copy."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, H, S, hd) and k, v "
                         f"(B, K, S, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, hd) or k.shape[1] == 0 \
            or H % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (H a multiple of K)")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention takes three f32 or three bf16 "
                         f"inputs, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"flash_attention inputs on {q.device}, "
                         f"{k.device} and {v.device}")


def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                    causal: bool = True) -> Tensor:
    """q: (B, H, S, hd); k, v: (B, K, S, hd), H % K == 0 -> (B, H, S, hd)
    in q's dtype and layout."""
    _check(q, k, v)
    if q.device.type == "cpu":
        out = torch.empty_like(q)
        return out.copy_(flash_attention_plain(q, k, v, causal))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if route(q.dtype, q.shape[-1]) == "sm90":
        return launch_sm90(q, k, v, causal)
    return launch_cuda_core(q, k, v, causal)


def launch_cuda_core(q: Tensor, k: Tensor, v: Tensor,
                     causal: bool = True) -> Tensor:
    """The CUDA-core kernel (csrc/flash_attention.cu) on CUDA tensors."""
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
    if out.numel() == 0:
        return out
    build.launch("flash_attention", _ARGTYPES, q, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
                 k.shape[1], S, hd, int(causal), _DTYPE_CODES[q.dtype],
                 *q.stride()[:3], *k.stride()[:3], *out.stride()[:3])
    _count("cuda_core")
    return out


def launch_sm90(q: Tensor, k: Tensor, v: Tensor,
                causal: bool = True) -> Tensor:
    """The tensor-core kernel (csrc/flash_attention_sm90.cu) on bf16 CUDA
    tensors at hd 16, 64 or 128, read through TMA maps."""
    B, H, S, hd = q.shape
    if q.dtype != torch.bfloat16 or hd not in SM90_HD:
        raise ValueError(f"the sm90 kernel takes bf16 at hd {SM90_HD}; got "
                         f"{q.dtype} at hd {hd}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = [s for t in (q, k, v) for s in tma_strides(t)]
    build.launch("flash_attention_sm90", _SM90_ARGTYPES, q, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
                 k.shape[1], S, hd, int(causal), *strides,
                 *out.stride()[:3])
    _count("sm90")
    return out


def _count(name: str) -> None:
    flash_attention.launches += 1
    flash_attention.route_launches[name] += 1


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
