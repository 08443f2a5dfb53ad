"""SVM scoring kernels: the window scorer and the dense scoring matmuls.

  * ``svm_scores`` -- (B, F) window descriptors, f32 or bf16, . (F,) f32
    weights + b -> (B,) f32 scores, f32 accumulation, each bf16 feature
    upcast exactly before its product. Replaces the TPU kernel
    repro/kernels/svm_matmul.py:38, CUDA source csrc/svm_scores.cu. Bound
    on the H100: bytes, 15.1 KB (f32) or 7.6 KB (bf16) per row, 27 / 13 us
    for B = 5,949 rows at 3.35 TB/s; each row cut into 8 segments, a warp
    a segment, 16-byte loads, 4 accumulators a lane, in an order fixed by
    F and the dtype (``svm_order``), so a row's score does not depend on
    its batch; rows a CTA from ``svm_scores_plan``.

The dense scorer multiplies (M, K) block rows by (K, N) per-offset
weights:

  * ``score_matmul`` -- f32 or bf16 in, f32 accumulation and out.
    Replaces the TPU kernel repro/kernels/svm_matmul.py:80, CUDA source
    csrc/score_matmul.cu.
  * ``score_matmul_int8`` -- int8 codes in, exact int32 out, the fixed
    chain's scorer. Replaces repro/kernels/svm_matmul.py:118, CUDA source
    csrc/score_matmul_int8.cu.

Both are one design (csrc/score_tile.cuh). Bound on the H100: bytes, most
of them the output -- a 640x480 frame's 9,189 rows read 1.32 MB and write
3.86 MB in f32, 1.56 us at 3.35 TB/s -- against about 1.1 us of launch
floor per level.

The launch plan (``score_plan``: grid, rows per pass, threads, shared
memory) is computed here, once per shape, and the launcher refuses any
other: one CTA per SM, each over a contiguous span of 4-row units
balanced to within one unit, the weights staged once per CTA, the outputs
written as one contiguous span of 16-byte stores. f32 multiplies on the
CUDA cores (a 4 x 4 register micro-tile per thread, fmaf in k order),
bf16 and int8 on the tensor cores (mma.sync).

Stacked SVM heads widen the product to (M, K) @ (K, NH * heads), the
columns head-major (column h*NH + o is head h's offset o, as
repro/core/detector.py:_score_blocks_multi lays them out). ``heads``
adds a second grid axis: each CTA stages one head's (K, NH) weights and
runs the one-head body, the SMs split between the heads, so one launch
scores every head, any number of them, in one head's shared memory, and
head h's columns equal its one-head launch's bit for bit.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (``svm_scores_plain``, ``score_matmul_plain``,
``score_matmul_int8_plain``) for a CPU tensor; nothing else.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

import torch

from . import build
from .build import SMS
from .tile_plan import Resident

Tensor = torch.Tensor

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_K, _MAX_N = 64, 128        # csrc/score_tile.cuh: MAX_K, MAX_N (a head)
#: threads a scorer CTA may have (score::MAX_THREADS): one per 4 x 4
#: micro-tile of a pass, so a pass holds SCORE_THREADS // ceil(N/4) units
SCORE_THREADS = 512
#: the vec flags (score::VEC_X, VEC_W, VEC_OUT): operands whose copies go
#: in 16-byte chunks
VEC_X, VEC_W, VEC_OUT = 1, 2, 4

# x, w, out, M, K, N, then the plan's grid, heads, pass_units, threads,
# smem_bytes and the vec flags; the f32/bf16 kernel also takes its dtype
# code after N
_PLAN_ARGS = (ctypes.c_int,) * 6
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + _PLAN_ARGS
             + (ctypes.c_void_p,))


@dataclasses.dataclass(frozen=True)
class ScorePlan:
    """How the scorer covers an (M, K) @ (K, N) product: rows in units of
    4, ``units`` of them; CTA b of ``grid`` owns the contiguous units
    [b*units // grid, (b+1)*units // grid) and walks them in passes of at
    most ``pass_units`` (csrc/score_tile.cuh:run), for each of ``heads``
    column groups of ``nh`` columns (the grid's second axis)."""
    M: int
    K: int
    N: int                          # every head's columns
    itemsize: int                   # bytes of an input element
    units: int
    grid: int                       # CTAs of one head
    pass_units: int
    threads: int
    smem_bytes: int
    heads: int = 1

    @property
    def nh(self) -> int:
        """Columns of one head."""
        return self.N // self.heads

    @property
    def ctas(self) -> int:
        """CTAs of the launch, every head's."""
        return self.grid * self.heads

    @property
    def rows(self) -> int:
        """Rows of the busiest CTA (and SM): 4 * ceil(units / grid)."""
        return 4 * -(-self.units // self.grid)

    def span(self, b: int) -> Tuple[int, int]:
        """Rows [r0, r1) of CTA b."""
        u0 = b * self.units // self.grid
        u1 = (b + 1) * self.units // self.grid
        return 4 * u0, min(4 * u1, self.M)

    def passes(self, b: int) -> List[Tuple[int, int]]:
        """(first row, rows) of each pass of CTA b."""
        r0, r1 = self.span(b)
        step = 4 * self.pass_units
        return [(r, min(step, r1 - r)) for r in range(r0, r1, step)]


def score_smem_bytes(K: int, N: int, itemsize: int, pass_units: int) -> int:
    """Shared memory of one scorer CTA (score::layout): the weights as
    they are (K x N), two slabs of a pass's rows (rows of K rounded up to
    4 input elements), the pass's (rows x N) 4-byte outputs."""
    P = 4 * pass_units

    def r16(b):
        return -(-b // 16) * 16

    return (r16(K * N * itemsize) + 2 * r16(P * -(-K // 4) * 4 * itemsize)
            + P * N * 4)


@functools.lru_cache(maxsize=None)
def score_plan(M: int, N: int, dtype: torch.dtype, sms: int = SMS,
               K: int = 36, heads: int = 1) -> ScorePlan:
    """The launch plan of ``score_matmul`` / ``score_matmul_int8`` for an
    (M, K) @ (K, N) product of ``dtype`` inputs, N = ``heads`` groups of
    at most _MAX_N columns, on a card of ``sms`` SMs: one CTA per SM in
    all (sms // heads a head, at least one; fewer only when M has fewer
    4-row units), each over a span of floor or ceil(units / grid) units,
    so the busiest SM has the fewest rows possible; passes as even as the
    micro-tiles a CTA's SCORE_THREADS hold allow."""
    if heads < 1 or heads > 65535 or N % heads:
        raise ValueError(f"no scorer plan for N={N} in {heads} heads")
    nh = N // heads
    if M < 1 or not (1 <= K <= _MAX_K and 1 <= nh <= _MAX_N):
        raise ValueError(f"no scorer plan for M={M}, K={K}, N={N} "
                         f"({heads} heads of {nh}; a head takes at most "
                         f"{_MAX_N} columns, K at most {_MAX_K})")
    itemsize = dtype.itemsize
    units = -(-M // 4)
    grid = min(max(1, sms // heads), units)
    if units * grid >= 2 ** 31:        # the kernel's span arithmetic is int
        raise ValueError(f"no scorer plan for M={M} on {sms} SMs")
    most = -(-units // grid)                # units of the busiest CTA
    ng = -(-nh // 4)
    npass = -(-most // (SCORE_THREADS // ng))
    pass_units = -(-most // npass)
    return ScorePlan(M, K, N, itemsize, units, grid, pass_units,
                     -(-pass_units * ng // 32) * 32,
                     score_smem_bytes(K, nh, itemsize, pass_units), heads)


def vec_flags(x: Tensor, w: Tensor, out: Tensor, heads: int = 1) -> int:
    """The operands the kernel may copy in 16-byte chunks: x when its
    base is 16-byte aligned and its rows hold a multiple of 4 elements
    (then every 4-row unit starts aligned and the staged rows need no
    padding), w and out when their base is aligned and, with several
    heads, a head's columns fill whole 16-byte chunks (then each head's
    rows start aligned); the others go element by element."""
    nh = w.shape[1] // heads

    def whole(t, itemsize):
        return t.data_ptr() % 16 == 0 and (heads == 1
                                           or nh * itemsize % 16 == 0)

    return ((VEC_X if x.data_ptr() % 16 == 0 and x.shape[1] % 4 == 0
             else 0)
            | (VEC_W if whole(w, w.element_size()) else 0)
            | (VEC_OUT if whole(out, 4) else 0))


def _launch_scorer(name: str, argtypes, x: Tensor, w: Tensor, out: Tensor,
                   heads: int, *extra) -> None:
    """Launch ``name`` on the plan of its shape and the card's SMs."""
    M, K = x.shape
    N = w.shape[1]
    plan = score_plan(M, N, x.dtype, build.sm_count(x.device.index), K,
                      heads)
    build.launch(name, argtypes, x, x.data_ptr(), w.data_ptr(),
                 out.data_ptr(), M, K, N, *extra, plan.grid, heads,
                 plan.pass_units, plan.threads, plan.smem_bytes,
                 vec_flags(x, w, out, heads))


def _check_heads(name: str, K: int, N: int, heads: int) -> None:
    """The widths the CUDA kernel takes: K <= _MAX_K, and N in ``heads``
    equal groups of at most _MAX_N columns; a ValueError names the limit
    (there is no fallback)."""
    if heads < 1 or N % heads:
        raise ValueError(f"{name}: N={N} does not split into {heads} heads")
    if K > _MAX_K or N // heads > _MAX_N:
        raise ValueError(f"the CUDA kernel takes K <= {_MAX_K} and at most "
                         f"{_MAX_N} columns a head; got K={K}, N={N} in "
                         f"{heads} heads (pass heads= to split N)")


def score_matmul_plain(flat: Tensor, wt: Tensor) -> Tensor:
    """The same function in plain tensor ops, on any device. Both inputs
    are upcast first: torch.matmul of two bf16 tensors returns bf16,
    where the reference accumulates and returns f32
    (repro/kernels/svm_matmul.py:74-76)."""
    return torch.matmul(flat.to(torch.float32), wt.to(torch.float32))


def score_matmul(flat: Tensor, wt: Tensor, heads: int = 1) -> Tensor:
    """(M, K) block rows @ (K, N) per-offset weights -> (M, N) f32; N in
    ``heads`` head-major groups, all scored by one launch."""
    _check_pair("score_matmul", flat, wt)
    if flat.dtype != wt.dtype or flat.dtype not in _DTYPE_CODES:
        raise ValueError(f"score_matmul takes two f32 or two bf16 inputs, "
                         f"got {flat.dtype} and {wt.dtype}")
    if flat.device.type == "cpu":
        _check_heads("score_matmul", *wt.shape, heads)
        return score_matmul_plain(flat, wt)
    if flat.device.type != "cuda":
        raise ValueError(f"score_matmul: unsupported device {flat.device}")
    M, K = flat.shape
    N = wt.shape[1]
    _check_heads("score_matmul", K, N, heads)
    if not (flat.is_contiguous() and wt.is_contiguous()):
        raise ValueError("score_matmul: inputs must be contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=flat.device)
    if M == 0:
        return out
    _launch_scorer("score_matmul", _ARGTYPES, flat, wt, out, heads,
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


_ARGTYPES_I8 = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + _PLAN_ARGS
                + (ctypes.c_void_p,))


def score_matmul_int8_plain(q: Tensor, wq: Tensor) -> Tensor:
    """The same function in plain tensor ops, on any device: an f32
    product of the upcast codes, returned as int32. It is exact: every
    product (<= 127^2) and every partial sum (<= 64 * 127^2 < 2^24) is an
    integer that f32 holds exactly, in any summation order. (cuBLAS has
    no int32 product, so an int32 matmul would not run on the card.)"""
    return torch.matmul(q.to(torch.float32),
                        wq.to(torch.float32)).to(torch.int32)


def score_matmul_int8(q: Tensor, wq: Tensor, heads: int = 1) -> Tensor:
    """(M, K) int8 block codes @ (K, N) int8 weight codes -> (M, N) int32,
    exact; N in ``heads`` head-major groups, all scored by one launch."""
    _check_pair("score_matmul_int8", q, wq)
    if q.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"score_matmul_int8 takes two int8 inputs, got "
                         f"{q.dtype} and {wq.dtype}")
    if q.device.type == "cpu":
        _check_heads("score_matmul_int8", *wq.shape, heads)
        return score_matmul_int8_plain(q, wq)
    if q.device.type != "cuda":
        raise ValueError(f"score_matmul_int8: unsupported device {q.device}")
    M, K = q.shape
    N = wq.shape[1]
    _check_heads("score_matmul_int8", K, N, heads)
    if not (q.is_contiguous() and wq.is_contiguous()):
        raise ValueError("score_matmul_int8: inputs must be contiguous")
    out = torch.empty((M, N), dtype=torch.int32, device=q.device)
    if M == 0:
        return out
    _launch_scorer("score_matmul_int8", _ARGTYPES_I8, q, wq, out, heads)
    score_matmul_int8.launches += 1
    return out


score_matmul_int8.launches = 0


# feats, w, bias, out, B, F, dtype code, then the plan's rows, grid,
# threads and smem_bytes, and the stream
_ARGTYPES_SVM = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7
                 + (ctypes.c_void_p,))

#: accumulators a lane keeps and threads of a CTA (csrc/svm_scores.cu:
#: ACC, THREADS)
SVM_ACC, SVM_THREADS = 4, 256
#: segments a row's units are cut into, per dtype (F32::SEGS, BF16::SEGS):
#: about 1.9 KB each at F = 3,780; a CTA's 8 warps take 8 / SEGS rows,
#: one warp a segment
SVM_SEGS = {torch.float32: 8, torch.bfloat16: 4}


def svm_order(F: int, dtype: torch.dtype) -> Tuple[int, List[Tuple[int, int]],
                                                   int]:
    """The summation order of ``svm_scores``, fixed by F and the dtype
    alone: (features a unit holds -- 16 bytes: 4 f32 or 8 bf16 --, the
    SVM_SEGS[dtype] segments [u0, u1) of the row's F // unit units, the
    tail's first feature). Lane l of a segment's warp adds units u0 + 32 j
    + l, product by product, into its accumulator j % SVM_ACC; the score is
    ((segment sums left to right) + tail) + b (csrc/svm_scores.cu)."""
    unit, segs = 16 // dtype.itemsize, SVM_SEGS[dtype]
    U = F // unit
    return (unit, [(s * U // segs, (s + 1) * U // segs)
                   for s in range(segs)], unit * U)


@dataclasses.dataclass(frozen=True)
class SvmPlan(Resident):
    """How ``svm_scores`` covers B rows: CTA i owns rows ``owned(i)``,
    warp w segment w % segs of row w // segs."""
    B: int
    F: int
    itemsize: int
    segs: int                       # segments of a row
    rows: int                       # rows a CTA (8 warps / segs)
    threads: int
    smem_bytes: int

    @property
    def tile(self) -> Tuple[int]:
        """The compiled shape a CTA takes (the occupancy entry point's
        argument)."""
        return (self.rows,)

    @property
    def ctas(self) -> int:
        return -(-self.B // self.rows)

    def owned(self, i: int) -> Tuple[int, int]:
        """Rows [r0, r1) of CTA ``i``."""
        return min(i * self.rows, self.B), min(i * self.rows + self.rows,
                                               self.B)

    def segment_of(self, warp: int) -> Tuple[int, int]:
        """(row within the CTA, segment) of ``warp``."""
        return divmod(warp, self.segs)


@functools.lru_cache(maxsize=None)
def svm_scores_plan(B: int, F: int, dtype: torch.dtype) -> SvmPlan:
    """The launch plan of ``svm_scores`` for B rows of F features: one
    warp a segment, so a CTA of SVM_THREADS takes 8 / SVM_SEGS[dtype] rows
    (1 f32, 2 bf16) and the batch ceil(B / rows) CTAs; every SM has a CTA
    from 132 (f32) or 264 (bf16) rows up on the H100. The summation order
    does not depend on it."""
    if B < 1 or F < 1 or dtype not in _DTYPE_CODES:
        raise ValueError(f"svm_scores: no plan for {B} rows of {F} {dtype}")
    segs = SVM_SEGS[dtype]
    rows = SVM_THREADS // 32 // segs
    return SvmPlan(B, F, dtype.itemsize, segs, rows, SVM_THREADS,
                   4 * rows * (segs + 1))


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
    if B == 0:
        return out
    return _svm_launch(feats, w, bias, svm_scores_plan(B, F, feats.dtype),
                       out)


def _svm_launch(feats: Tensor, w: Tensor, bias: Tensor, plan: SvmPlan,
                out: Tensor) -> Tensor:
    B, F = feats.shape
    build.launch("svm_scores", _ARGTYPES_SVM, feats, feats.data_ptr(),
                 w.data_ptr(), bias.data_ptr(), out.data_ptr(), B, F,
                 _DTYPE_CODES[feats.dtype], plan.rows, plan.ctas,
                 plan.threads, plan.smem_bytes)
    svm_scores.launches += 1
    return out


svm_scores.launches = 0
