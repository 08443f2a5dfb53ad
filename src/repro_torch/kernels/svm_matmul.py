"""Dense SVM scoring matmul: (M, K) block rows @ (K, N) per-offset
weights -> (M, N) f32, from f32 or bf16 inputs with f32 accumulation.

Replaces the TPU kernel repro/kernels/svm_matmul.py:80 (``score_matmul``),
CUDA source csrc/score_matmul.cu. Its int8 twin ``score_matmul_int8``
(:118) is the quant preset's, slice 2; ``svm_scores`` (:38) serves the
window path, a later slice.

Bound on the H100: at the largest 640x480 level (M = 4524, K = 36,
N = 105) the work is 34 MFLOP and 2.6 MB of traffic, about 0.8 us either
way -- below one launch. So the kernel stays on CUDA cores: each thread
block stages the 15 KB weight tile and a 32-row input slab in shared
memory and its threads write consecutive outputs.

``score_matmul`` launches the kernel for a CUDA tensor and runs the
plain version ``score_matmul_plain`` for a CPU tensor; nothing else.
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
    if flat.dim() != 2 or wt.dim() != 2 or flat.shape[1] != wt.shape[0]:
        raise ValueError(f"score_matmul shapes {tuple(flat.shape)} @ "
                         f"{tuple(wt.shape)} do not chain")
    if flat.dtype != wt.dtype or flat.dtype not in _DTYPE_CODES:
        raise ValueError(f"score_matmul takes two f32 or two bf16 inputs, "
                         f"got {flat.dtype} and {wt.dtype}")
    if flat.device != wt.device:
        raise ValueError(f"score_matmul inputs on {flat.device} and "
                         f"{wt.device}")
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
