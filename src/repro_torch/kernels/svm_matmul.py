"""SVM scoring kernels: the window scorer and the dense scoring matmuls.

  * ``svm_scores`` -- (B, F) window descriptors, f32 or bf16, . (F,) f32
    weights + b -> (B,) f32 scores, f32 accumulation, each bf16 feature
    upcast exactly before its product. Replaces the TPU kernel
    repro/kernels/svm_matmul.py:38, CUDA source csrc/svm_scores.cu. Bound
    on the H100: bytes, 15.1 KB (f32) or 7.6 KB (bf16) per row, 27 / 13 us
    for B = 5,949 rows at 3.35 TB/s; one warp per row, vector loads, a
    warp-shuffle sum.

The dense scorer multiplies (M, K) block rows by (K, N) per-offset
weights:

  * ``score_matmul`` -- f32 or bf16 in, f32 accumulation and out.
    Replaces the TPU kernel repro/kernels/svm_matmul.py:80, CUDA source
    csrc/score_matmul.cu.
  * ``score_matmul_int8`` -- int8 codes in, exact int32 out, the fixed
    chain's scorer. Replaces repro/kernels/svm_matmul.py:118, CUDA source
    csrc/score_matmul_int8.cu.

Bound on the H100: at the largest 640x480 level (M = 4524, K = 36,
N = 105) the work is 34 MFLOP and 2.6 MB of traffic, about 0.8 us either
way -- below one launch. So the kernel stays on CUDA cores: each thread
block stages the 15 KB weight tile and a 32-row input slab in shared
memory and its threads write consecutive outputs.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (``svm_scores_plain``, ``score_matmul_plain``,
``score_matmul_int8_plain``) for a CPU tensor; nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

Tensor = torch.Tensor

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_K, _MAX_N = 64, 128        # (K*N + 32*K) floats stay under 48 KB

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def score_matmul_plain(flat: Tensor, wt: Tensor) -> Tensor:
    """The same function in plain tensor ops, on any device. Both inputs
    are upcast first: torch.matmul of two bf16 tensors returns bf16,
    where the reference accumulates and returns f32
    (repro/kernels/svm_matmul.py:74-76)."""
    return torch.matmul(flat.to(torch.float32), wt.to(torch.float32))


def score_matmul(flat: Tensor, wt: Tensor) -> Tensor:
    """(M, K) block rows @ (K, N) per-offset weights -> (M, N) f32."""
    _check_pair("score_matmul", flat, wt)
    if flat.dtype != wt.dtype or flat.dtype not in _DTYPE_CODES:
        raise ValueError(f"score_matmul takes two f32 or two bf16 inputs, "
                         f"got {flat.dtype} and {wt.dtype}")
    if flat.device.type == "cpu":
        return score_matmul_plain(flat, wt)
    if flat.device.type != "cuda":
        raise ValueError(f"score_matmul: unsupported device {flat.device}")
    M, K = flat.shape
    N = wt.shape[1]
    if K > _MAX_K or N > _MAX_N:
        raise ValueError(f"the CUDA kernel takes K <= {_MAX_K}, N <= "
                         f"{_MAX_N}; got K={K}, N={N}")
    if not (flat.is_contiguous() and wt.is_contiguous()):
        raise ValueError("score_matmul: inputs must be contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=flat.device)
    build.launch("score_matmul", _ARGTYPES, flat, flat.data_ptr(),
                 wt.data_ptr(), out.data_ptr(), M, K, N,
                 _DTYPE_CODES[flat.dtype])
    score_matmul.launches += 1
    return out


score_matmul.launches = 0


def _check_pair(name: str, flat: Tensor, wt: Tensor) -> None:
    if flat.dim() != 2 or wt.dim() != 2 or flat.shape[1] != wt.shape[0]:
        raise ValueError(f"{name} shapes {tuple(flat.shape)} @ "
                         f"{tuple(wt.shape)} do not chain")
    if flat.device != wt.device:
        raise ValueError(f"{name} inputs on {flat.device} and {wt.device}")


_ARGTYPES_I8 = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def score_matmul_int8_plain(q: Tensor, wq: Tensor) -> Tensor:
    """The same function in plain tensor ops, on any device: an f32
    product of the upcast codes, returned as int32. It is exact: every
    product (<= 127^2) and every partial sum (<= 64 * 127^2 < 2^24) is an
    integer that f32 holds exactly, in any summation order. (cuBLAS has
    no int32 product, so an int32 matmul would not run on the card.)"""
    return torch.matmul(q.to(torch.float32),
                        wq.to(torch.float32)).to(torch.int32)


def score_matmul_int8(q: Tensor, wq: Tensor) -> Tensor:
    """(M, K) int8 block codes @ (K, N) int8 weight codes -> (M, N) int32,
    exact."""
    _check_pair("score_matmul_int8", q, wq)
    if q.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"score_matmul_int8 takes two int8 inputs, got "
                         f"{q.dtype} and {wq.dtype}")
    if q.device.type == "cpu":
        return score_matmul_int8_plain(q, wq)
    if q.device.type != "cuda":
        raise ValueError(f"score_matmul_int8: unsupported device {q.device}")
    M, K = q.shape
    N = wq.shape[1]
    if K > _MAX_K or N > _MAX_N:
        raise ValueError(f"the CUDA kernel takes K <= {_MAX_K}, N <= "
                         f"{_MAX_N}; got K={K}, N={N}")
    if not (q.is_contiguous() and wq.is_contiguous()):
        raise ValueError("score_matmul_int8: inputs must be contiguous")
    out = torch.empty((M, N), dtype=torch.int32, device=q.device)
    build.launch("score_matmul_int8", _ARGTYPES_I8, q, q.data_ptr(),
                 wq.data_ptr(), out.data_ptr(), M, K, N)
    score_matmul_int8.launches += 1
    return out


score_matmul_int8.launches = 0


_ARGTYPES_SVM = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p)


def svm_scores_plain(feats: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    """The same function in plain tensor ops, on any device. Both
    operands are upcast to f32 first (exact for bf16), as the reference
    kernel promotes bf16 features against its f32 weights; a bf16
    torch.matmul would round its result to bf16."""
    return torch.matmul(feats.to(torch.float32), w.to(torch.float32)) + bias


def svm_scores(feats: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    """(B, F) f32 or bf16 descriptors . (F,) f32 weights + () f32 bias
    -> (B,) f32 scores."""
    if feats.dim() != 2 or w.dim() != 1 or feats.shape[1] != w.shape[0]:
        raise ValueError(f"svm_scores shapes {tuple(feats.shape)} . "
                         f"{tuple(w.shape)} do not chain")
    if feats.dtype not in _DTYPE_CODES or w.dtype != torch.float32 \
            or bias.dtype != torch.float32 or bias.numel() != 1:
        raise ValueError(f"svm_scores takes f32 or bf16 features, f32 "
                         f"weights and one f32 bias, got {feats.dtype}, "
                         f"{w.dtype} and {bias.dtype} {tuple(bias.shape)}")
    if not feats.device == w.device == bias.device:
        raise ValueError(f"svm_scores inputs on {feats.device}, {w.device} "
                         f"and {bias.device}")
    if feats.device.type == "cpu":
        return svm_scores_plain(feats, w, bias.reshape(()))
    if feats.device.type != "cuda":
        raise ValueError(f"svm_scores: unsupported device {feats.device}")
    if not (feats.is_contiguous() and w.is_contiguous()):
        raise ValueError("svm_scores: inputs must be contiguous")
    B, F = feats.shape
    out = torch.empty((B,), dtype=torch.float32, device=feats.device)
    build.launch("svm_scores", _ARGTYPES_SVM, feats, feats.data_ptr(),
                 w.data_ptr(), bias.data_ptr(), out.data_ptr(), B, F,
                 _DTYPE_CODES[feats.dtype])
    svm_scores.launches += 1
    return out


svm_scores.launches = 0
