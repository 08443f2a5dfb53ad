"""The launch plan of the dense scorers score_matmul and score_matmul_int8
(repro_torch/kernels/svm_matmul.py:score_plan), checked on the CPU at the
shapes chip_smoke.py runs them at -- the block rows of every pyramid level
of 640x480 and 1280x720, its ragged shape, and M = 1, 3, 5, 131, 133.

The CUDA kernels (csrc/score_tile.cuh) follow the plan: CTA b owns a
contiguous span of 4-row units and walks it in passes; per pass each f32
thread makes a 4 x 4 micro-tile, and each bf16 or int8 warp mma tiles of
16 rows x 8 columns, from the weights and rows staged in shared memory.
Here ``emulate`` and ``emulate_mma`` run the same index arithmetic in
numpy -- the staged rows, the micro-tile of each thread id with k in
order, the fragments each lane loads, the padding of K and N, the flat
store of each pass -- so a tiling error fails without a card. Stacked
heads (N = 105 K, a second grid axis) are checked the same way: every
head's columns against that head scored alone.
"""
import dataclasses
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import svm_matmul as sm

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _rows(B, H, W):
    """Block rows M of a (B, H, W) level: (ch-1) x (cw-1) blocks each."""
    return B * ((H - 2) // 8 - 1) * ((W - 2) // 8 - 1)


LEVELS = {f"{w}x{h}": [_rows(1, *s) for s in chip_smoke.level_shapes(h, w)]
          for h, w in chip_smoke.FRAME_SIZES}
TAILS = [1, 3, 5, 131, 133]
MS = [m for v in LEVELS.values() for m in v] + [_rows(*chip_smoke.RAGGED)] \
    + TAILS
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
N, K = 105, 36


def test_level_rows_are_the_detectors():
    assert LEVELS["640x480"] == [4524, 2852, 1813]
    assert LEVELS["1280x720"] == [14220, 9072, 5757]
    assert _rows(*chip_smoke.RAGGED) == 494      # 2 x 13 x 19 blocks


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("M", MS)
def test_plan_covers_every_row_once(M, dt):
    plan = sm.score_plan(M, N, DTYPES[dt])
    seen = np.zeros(M, np.int32)
    sizes = []
    for b in range(plan.grid):
        r0, r1 = plan.span(b)
        assert r1 > r0                  # every CTA of the grid owns rows
        assert r0 % 4 == 0              # a span starts on a 4-row unit
        seen[r0:r1] += 1
        sizes.append(r1 - r0)
        # rows per CTA are whole 4-row units, the last CTA's masked
        assert (r1 - r0) % 4 == 0 or (b == plan.grid - 1 and r1 == M)
        passes = plan.passes(b)
        assert [p[0] for p in passes] == list(
            range(r0, r1, 4 * plan.pass_units))
        assert sum(n for _, n in passes) == r1 - r0
        assert all(0 < n <= 4 * plan.pass_units for _, n in passes)
    assert (seen == 1).all()
    # balanced to within one unit; the busiest CTA has plan.rows rows
    units = [-(-s // 4) for s in sizes]
    assert max(units) - min(units) <= 1
    assert 4 * max(units) == plan.rows


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("M", MS)
def test_plan_fills_the_card_with_the_fewest_rows_per_sm(M, dt):
    plan = sm.score_plan(M, N, DTYPES[dt])
    units = -(-M // 4)
    assert plan.units == units
    # at least one CTA per SM wherever M has the units for it
    assert plan.grid == min(sm.SMS, units)
    if units >= sm.SMS:
        assert plan.grid >= 132
    # one CTA per SM: the busiest SM has ceil(units / SMs) units, the
    # fewest any split into 4-row units allows
    assert plan.rows == 4 * -(-units // min(sm.SMS, units))
    # a pass's micro-tiles fit the CTA's threads, in whole warps
    ng = -(-N // 4)
    assert plan.pass_units * ng <= plan.threads <= sm.SCORE_THREADS
    assert plan.threads % 32 == 0 and plan.threads - plan.pass_units * ng < 32
    # as few passes as the threads allow, as even as they can be
    npass = -(-plan.rows // 4 // (sm.SCORE_THREADS // ng))
    assert len(max((plan.passes(b) for b in range(plan.grid)), key=len)) \
        == npass


def test_plan_at_640x480_and_1280x720():
    """One CTA per SM at every level; 36 / 24 / 16 rows on the busiest SM
    at 640x480 (the 32-row tiles gave two CTAs, 64 rows, to ten SMs at
    level 1.0), one pass each; 108 / 72 / 44 rows in 2 / 1 / 1 passes at
    1280x720."""
    f32 = torch.float32
    plans = [sm.score_plan(m, N, f32) for m in LEVELS["640x480"]]
    assert [(p.grid, p.rows, p.pass_units, p.threads) for p in plans] == [
        (132, 36, 9, 256), (132, 24, 6, 192), (132, 16, 4, 128)]
    plans = [sm.score_plan(m, N, f32) for m in LEVELS["1280x720"]]
    assert [(p.rows, p.pass_units, p.threads, len(p.passes(0)))
            for p in plans] == [(108, 14, 384, 2), (72, 18, 512, 1),
                                (44, 11, 320, 1)]
    # another card: the grid follows its SMs
    assert sm.score_plan(4524, N, f32, sms=100).grid == 100


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("M", MS)
def test_plan_shared_memory_fits(M, dt):
    plan = sm.score_plan(M, N, DTYPES[dt])
    assert plan.smem_bytes == sm.score_smem_bytes(K, N, plan.itemsize,
                                                  plan.pass_units)
    assert plan.smem_bytes % 16 == 0         # every region 16-byte aligned
    # a pass of up to 72 rows fits an SM; 640x480's levels, the ragged
    # shape and the tails (passes of at most 36 rows) need no opt-in
    assert plan.smem_bytes <= build.SMEM_OPTIN
    if M not in LEVELS["1280x720"]:
        assert plan.smem_bytes <= build.SMEM_DEFAULT


@pytest.mark.parametrize("dt", DTYPES)
def test_plan_shared_memory_at_the_widest_shape(dt):
    # K = 64, N = 128: one unit a CTA, a warp of 32 micro-tiles, under
    # the opt-in limit
    plan = sm.score_plan(133, 128, DTYPES[dt], K=64)
    assert plan.smem_bytes <= build.SMEM_OPTIN
    assert plan.pass_units == 1 and plan.threads == 32


def test_plan_worked_example():
    # 640x480 level 1.0: the raw 36 x 105 weights (15,120 B in f32), two
    # slabs of 36 rows of 36 (2 x 5,184), the outputs (36 x 105 x 4 =
    # 15,120); bf16 and int8 hold the weights and rows in 2 and 1 bytes
    plan = sm.score_plan(4524, N, torch.float32)
    assert plan.smem_bytes == 15120 + 2 * 5184 + 15120 == 40608
    assert sm.score_smem_bytes(36, 105, 2, 9) == 7568 + 2 * 2592 + 15120
    assert sm.score_smem_bytes(36, 105, 1, 9) == 3792 + 2 * 1296 + 15120
    # K = 35: rows pad to 36 in the slabs, the weights stay 35 x 105
    assert sm.score_smem_bytes(35, 105, 4, 9) == 14704 + 2 * 5184 + 15120


def test_plan_matches_the_compiled_kernel():
    """The thread limit, operand limits, vec flags and launch arguments
    the wrapper passes are the ones csrc/score_tile.cuh and the two
    sources are compiled for, and the launcher re-derives the plan."""
    src = (build.CSRC / "score_tile.cuh").read_text()
    for expr in (rf"MAX_THREADS = {sm.SCORE_THREADS};",
                 rf"MAX_K = {sm._MAX_K};", rf"MAX_N = {sm._MAX_N};",
                 rf"VEC_X = {sm.VEC_X}, VEC_W = {sm.VEC_W}, "
                 rf"VEC_OUT = {sm.VEC_OUT};",
                 r"u0 = static_cast<int>\(blockIdx.x\) \* units / gridDim.x;",
                 r"units\) \* grid >= \(1LL << 31\)",
                 r"pass_units != \(umax \+ npass - 1\) / npass",
                 r"threads != \(pass_units \* NG \+ 31\) / 32 \* 32",
                 r"smem_bytes != layout<T>\(K, NH, pass_units\).total",
                 r"dim3\(grid, heads\)", r"N /= heads;"):
        assert re.search(expr, src), expr
    for name, argtypes in (("score_matmul", sm._ARGTYPES),
                           ("score_matmul_int8", sm._ARGTYPES_I8)):
        cu = (build.CSRC / build.SOURCES[name]).read_text()
        assert '#include "score_tile.cuh"' in cu
        assert "__launch_bounds__(score::MAX_THREADS, 1)" in cu
        args = re.search(rf"int {name}_launch\(([^)]*)\)", cu)[1]
        assert len(args.split(",")) == len(argtypes)
    assert len(sm._ARGTYPES) == 14 and len(sm._ARGTYPES_I8) == 13


def test_vec_flags_follow_alignment():
    """16-byte copies only where the operand allows them; a view at an
    odd offset (x[1:] of a flat buffer) goes element by element."""
    for dt in DTYPES.values():
        x = torch.zeros((133, K), dtype=dt)
        w = torch.zeros((K, N), dtype=dt)
        out = torch.zeros((133, N), dtype=torch.float32)
        assert sm.vec_flags(x, w, out) == 7
        buf = torch.zeros(133 * K + 1, dtype=dt)
        xv = buf[1:].view(133, K)
        assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
        assert sm.vec_flags(xv, w, out) == sm.VEC_W | sm.VEC_OUT
        wbuf = torch.zeros(K * N + 1, dtype=dt)
        assert sm.vec_flags(x, wbuf[1:].view(K, N), out) == \
            sm.VEC_X | sm.VEC_OUT
    # rows of 35 values are staged element by element into rows of 36
    x = torch.zeros((8, 35), dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    assert sm.vec_flags(x, torch.zeros((35, N), dtype=torch.bfloat16),
                        torch.zeros((8, N))) == sm.VEC_W | sm.VEC_OUT


def test_plan_refuses_shapes_the_kernel_does_not_take():
    for M, n, k in ((0, N, K), (4, 129, K), (4, N, 65), (4, 0, K)):
        with pytest.raises(ValueError, match="plan"):
            sm.score_plan(M, n, torch.float32, K=k)


def test_plan_is_made_once_per_shape():
    # the wrapper asks for it at every launch, 3 times a frame
    assert sm.score_plan(4524, N, torch.int8, 132) is \
        sm.score_plan(4524, N, torch.int8, 132)
    assert sm.score_plan(4524, N, torch.int8, 132) is not \
        sm.score_plan(4524, N, torch.float32, 132)


# ------------------------------------------------------------ emulation

def _fma(a, b, acc):
    """fmaf: the product exact in f64, one rounding to f32."""
    return (a.astype(np.float64) * b + acc).astype(np.float32)


def emulate(plan, x, w, ctas=None):
    """csrc/score_tile.cuh:run for f32 in numpy, over every CTA (or those
    of ``ctas``) and pass of the plan: x (M, K) and w (K, N) f32, the 4 x
    4 micro-tile of each thread id (rows 4u..4u+3, columns cg + NG j), k
    in order, the raw weights' last row read past K and column 0 past
    N."""
    M, Kx = x.shape
    Nw = w.shape[1]
    Kp, NG = -(-Kx // 4) * 4, -(-Nw // 4)
    P = 4 * plan.pass_units
    out = np.zeros(M * Nw, np.float32)
    written = np.zeros(M * Nw, np.int32)
    tid = np.arange(plan.threads)
    u, cg = tid // NG, tid - (tid // NG) * NG
    lanes = np.arange(4)
    for b in (range(plan.grid) if ctas is None else ctas):
        for row0, rows in plan.passes(b):
            # the pass's rows staged in rows of Kp (zero past K; rows past
            # the pass hold whatever the slab held before: here NaN)
            xs = np.full((P, Kp), np.nan, np.float32)
            xs[:rows] = 0
            xs[:rows, :Kx] = x[row0:row0 + rows]
            live = 4 * u < rows
            ri = 4 * u[live][:, None] + lanes          # (T, 4) rows
            ci = cg[live][:, None] + NG * lanes        # (T, 4) columns
            cs = np.where(ci < Nw, ci, 0)
            acc = np.zeros((len(ri), 4, 4), np.float32)
            for k in range(Kp):                       # k in order
                acc = _fma(xs[ri, k][:, :, None],
                           w[min(k, Kx - 1), cs][:, None, :], acc)
            rr, cc = np.broadcast_arrays(ri[:, :, None], ci[:, None, :])
            _flush(out, written, row0, rows, Nw, P, rr, cc, acc)
    _check_written(written, ctas)
    return out.reshape(M, Nw)


def _check_written(written, ctas):
    """Every output written once (by the CTAs emulated: at most once)."""
    assert (written == 1).all() if ctas is None else (written <= 1).all()


def _flush(out, written, row0, rows, Nw, P, rr, cc, acc):
    """A pass's outputs into its row-major tile, then the tile's first
    rows * N values to the output's span."""
    keep = (rr < rows) & (cc < Nw)
    outs = np.zeros(P * Nw, out.dtype)
    outs[(rr * Nw + cc)[keep]] = acc[keep]
    out[row0 * Nw:(row0 + rows) * Nw] = outs[:rows * Nw]
    written[row0 * Nw:(row0 + rows) * Nw] += 1


def _mma_maps(pack, kstep):
    """The fragment maps of score::mma_tiles for lane = 4 g + t: the
    (row, k) of each A element (4 registers of pack), the (k, column) of
    each B element (2 registers) and the (row, column) of each C value."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    e = np.arange(pack)
    a = [(g[:, None] + 8 * (r % 2) + 0 * e,
          pack * t[:, None] + kstep // 2 * (r // 2) + e) for r in range(4)]
    b = [(pack * t[:, None] + kstep // 2 * r + e, g[:, None] + 0 * e)
         for r in range(2)]
    c = [(g + 8 * (j // 2), 2 * t + j % 2) for j in range(4)]
    return a, b, c


@pytest.mark.parametrize("pack,kstep", [(2, 16), (4, 32)],
                         ids=["bf16", "int8"])
def test_mma_fragment_maps_cover_each_tile_once(pack, kstep):
    """m16n8k16 (bf16) and m16n8k32 (int8) as the PTX ISA lays out their
    fragments: the lanes' registers hold every element of the 16 x kstep
    A tile, the kstep x 8 B tile and the 16 x 8 C tile exactly once."""
    a, b, c = _mma_maps(pack, kstep)
    for maps, shape in ((a, (16, kstep)), (b, (kstep, 8)), (c, (16, 8))):
        seen = np.zeros(shape, np.int32)
        for rows, cols in maps:
            np.add.at(seen, (rows, cols), 1)
        assert (seen == 1).all()


def emulate_mma(plan, x, w, pack, kstep, ctas=None):
    """score::run for bf16 (pack 2, mma depth 16) and int8 (pack 4, depth
    32) in numpy: each pass's rows staged in rows of Kp; the A fragments
    of every 16-row block and the B fragments of every 8-column tile
    gathered from the lanes' loads (A rows past the pass read the pass's
    last row, k at or past Kp or K reads 0, B columns past N read the
    last column); the tiles multiplied; the C values scattered back by
    lane."""
    int8 = pack == 4
    M, Kx = x.shape
    Nw = w.shape[1]
    Kp, P = -(-Kx // 4) * 4, 4 * plan.pass_units
    steps = -(-Kx // kstep)
    a_map, b_map, c_map = _mma_maps(pack, kstep)
    acc_t = np.int64 if int8 else np.float64
    NT, KD = -(-Nw // 8), steps * kstep
    B = np.zeros((KD, 8 * NT), acc_t)
    for s in range(steps):
        for nt in range(NT):
            for ks, cols in b_map:                 # b_word(w, k0, col)
                k = s * kstep + ks
                col = np.minimum(8 * nt + cols, Nw - 1)
                B[k, 8 * nt + cols] = np.where(
                    k < Kx, w[np.minimum(k, Kx - 1), col], 0)
    out = np.zeros(M * Nw, np.int32 if int8 else np.float32)
    written = np.zeros(M * Nw, np.int32)
    for b in (range(plan.grid) if ctas is None else ctas):
        for row0, rows in plan.passes(b):
            xs = np.zeros((P, Kp), x.dtype)
            xs[:rows, :Kx] = x[row0:row0 + rows]
            MT = -(-rows // 16)
            A = np.zeros((16 * MT, KD), acc_t)
            for m in range(MT):
                for s in range(steps):
                    for rws, ks in a_map:           # a_word(row, k, Kp)
                        k = s * kstep + ks
                        r = np.minimum(16 * m + rws, rows - 1)
                        A[16 * m + rws, k] = np.where(
                            k < Kp, xs[r, np.minimum(k, Kp - 1)], 0)
            C = A @ B
            rr = np.concatenate([16 * m + r for m in range(MT)
                                 for nt in range(NT) for r, _ in c_map])
            cc = np.concatenate([8 * nt + col for m in range(MT)
                                 for nt in range(NT) for _, col in c_map])
            _flush(out, written, row0, rows, Nw, P, rr, cc,
                   C[rr, cc].astype(out.dtype))
    _check_written(written, ctas)
    return out.reshape(M, Nw)


def _operands(M, Kx, Nw, dt, seed):
    rng = np.random.default_rng(seed)
    if dt == "int8":
        q = rng.integers(-127, 128, (M, Kx)).astype(np.int8)
        wq = rng.integers(-127, 128, (Kx, Nw)).astype(np.int8)
        q[0, :], wq[:, 0] = 127, -127     # the extreme sum, -K * 127^2
        return q, wq, torch.from_numpy(q), torch.from_numpy(wq)
    x = torch.from_numpy(rng.uniform(0, 0.5, (M, Kx)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.05, (Kx, Nw)).astype(np.float32))
    x, w = x.to(DTYPES[dt]), w.to(DTYPES[dt])
    return x.float().numpy(), w.float().numpy(), x, w


def _emulate(plan, dt, xn, wn, ctas=None):
    if dt == "f32":
        return emulate(plan, xn, wn, ctas)
    return emulate_mma(plan, xn, wn, *{"bf16": (2, 16), "int8": (4, 32)}[dt],
                       ctas=ctas)


def _check(plan, dt, xn, wn, xt, wt):
    got = _emulate(plan, dt, xn, wn)
    if dt == "int8":
        np.testing.assert_array_equal(
            got, sm.score_matmul_int8_plain(xt, wt).numpy())
    else:
        atol = chip_smoke.MATMUL_ATOL[dt]
        np.testing.assert_allclose(got, sm.score_matmul_plain(xt, wt).numpy(),
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("M", MS)
def test_emulated_tiling_equals_the_plain_version(M, dt):
    """int8 exactly; f32 within 1e-5 and bf16 within 1e-4, chip_smoke.py's
    limits for the kernels against the same plain versions."""
    _check(sm.score_plan(M, N, DTYPES[dt]), dt,
           *_operands(M, K, N, dt, seed=M))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kn", [(35, 50), (64, 128), (5, 1)],
                         ids=["K35xN50", "K64xN128", "K5xN1"])
def test_emulated_tiling_at_other_widths(kn, dt):
    """A K that is no multiple of 4 (a partial int8 word), the widest
    shape the wrapper takes, and a single column: the padding of N to 4
    and of K to a word."""
    k, n = kn
    for M, sms in ((133, 132), (300, 7)):
        _check(sm.score_plan(M, n, DTYPES[dt], sms, K=k), dt,
               *_operands(M, k, n, dt, seed=k * n))


def test_emulation_sees_a_tiling_error():
    """The emulations are not vacuous: a plan whose spans skip a unit
    fails them, and so, for f32, does a pass wider than the threads'
    micro-tiles (the tensor-core path takes its tiles by warp in turn)."""
    import dataclasses
    for dt in DTYPES:
        plan = sm.score_plan(1813, N, DTYPES[dt])
        ops = _operands(1813, K, N, dt, seed=1)
        short = dataclasses.replace(plan, units=plan.units - 1)
        with pytest.raises(AssertionError):
            _check(short, dt, *ops)
    plan = sm.score_plan(1813, N, torch.float32)
    narrow = dataclasses.replace(plan, threads=plan.threads - 32)
    with pytest.raises(AssertionError):
        _check(narrow, "f32", *_operands(1813, K, N, "f32", seed=1))


# ------------------------------------------------------- batches of frames

BATCHES = [(size, B) for size in LEVELS for B in (4, 8)]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("size,B", BATCHES,
                         ids=[f"{s}-B{b}" for s, b in BATCHES])
def test_plan_at_a_batch_gives_each_frame_its_own_rows(size, B, dt):
    """The detector scores B frames' block rows as one (B*M, 36) product.
    At B 4 and 8 frames of each 640x480 and 1280x720 level the plan covers
    every row once and fills the card; the CTAs on either side of each
    frame's seam, or across it (and the first and last), are emulated,
    and each of their
    rows equals, bit for bit, the row the single frame's plan gives that
    frame alone (and the plain version, within chip_smoke.py's limits)."""
    for m in LEVELS[size]:
        M = B * m
        plan = sm.score_plan(M, N, DTYPES[dt])
        assert plan.grid == build.SMS
        spans = [plan.span(c) for c in range(plan.grid)]
        assert spans[0][0] == 0 and spans[-1][1] == M
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        # the CTAs holding the last row of a frame or the first of the next
        edges = [f * m + d for f in range(1, B) for d in (-1, 0)]
        seam = sorted({0, plan.grid - 1} | {
            c for c, (r0, r1) in enumerate(spans)
            if any(r0 <= e < r1 for e in edges)})
        assert len(seam) >= B
        xn, wn, xt, wt = _operands(M, K, N, dt, seed=m + B)
        got = _emulate(plan, dt, xn, wn, ctas=seam)
        single = sm.score_plan(m, N, DTYPES[dt])
        for c in seam:
            r0, r1 = spans[c]
            for f in range(r0 // m, (r1 - 1) // m + 1):
                a, b = max(r0, f * m) - f * m, min(r1, (f + 1) * m) - f * m
                cover = [s for s in range(single.grid)
                         if single.span(s)[0] < b and single.span(s)[1] > a]
                alone = _emulate(single, dt, xn[f * m:(f + 1) * m], wn,
                                 ctas=cover)
                np.testing.assert_array_equal(got[f * m + a:f * m + b],
                                              alone[a:b])
        rows = np.concatenate([np.arange(*spans[c]) for c in seam])
        if dt == "int8":
            want = sm.score_matmul_int8_plain(xt[rows], wt).numpy()
            np.testing.assert_array_equal(got[rows], want)
        else:
            want = sm.score_matmul_plain(xt[rows], wt).numpy()
            np.testing.assert_allclose(got[rows], want, rtol=0,
                                       atol=chip_smoke.MATMUL_ATOL[dt])


# ------------------------------------------------------- stacked heads

def _coarse_rows():
    """Block rows of each level of the cascade's coarse sweep of a
    640x480 frame (scales 0.5, 0.4, 0.32 of the 480x640 bucket)."""
    out = []
    for sc in (0.5, 0.4, 0.32):
        sh, sw = int(480 * sc), int(640 * sc)
        out.append(_rows(1, (sh - 2) // 8 * 8 + 2, (sw - 2) // 8 * 8 + 2))
    return out


COARSE_N = 21                           # 7 x 3 blocks of a 66x34 window
HEAD_MS = LEVELS["640x480"] + LEVELS["1280x720"]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("heads", range(1, 9))
def test_widened_plan_splits_the_card_between_heads(heads, dt):
    """K = 1..8 heads of 105 columns at every 640x480 and 1280x720 level:
    one launch of K x grid CTAs, at most one per SM, each head's grid
    covering every row once; a CTA's shared memory and threads are the
    one-head plan's at its pass size, whatever K."""
    for M in HEAD_MS:
        plan = sm.score_plan(M, N * heads, DTYPES[dt], heads=heads)
        units = -(-M // 4)
        assert plan.nh == N and plan.heads == heads
        assert plan.grid == min(max(1, sm.SMS // heads), units)
        assert plan.ctas <= sm.SMS and plan.ctas > sm.SMS - heads
        one = sm.score_plan(M, N, DTYPES[dt], sms=plan.grid)
        assert (one.grid, one.pass_units, one.threads, one.smem_bytes) == \
            (plan.grid, plan.pass_units, plan.threads, plan.smem_bytes)
        seen = np.zeros(M, np.int32)
        for b in range(plan.grid):
            r0, r1 = plan.span(b)
            seen[r0:r1] += 1
        assert (seen == 1).all()
        assert plan.smem_bytes <= build.SMEM_OPTIN
        if heads == 1:
            assert plan == sm.score_plan(M, N, DTYPES[dt])


@pytest.mark.parametrize("dt", DTYPES)
def test_coarse_head_plan(dt):
    """The cascade's coarse head scores 21 columns: one head of 21, its
    levels' rows over the card as any single head's."""
    rows = _coarse_rows()
    assert rows == [1064, 660, 408]
    for M in rows:
        plan = sm.score_plan(M, COARSE_N, DTYPES[dt])
        assert plan.grid == min(sm.SMS, -(-M // 4)) and plan.heads == 1
        assert plan.smem_bytes <= build.SMEM_DEFAULT
        _check(plan, dt, *_operands(M, K, COARSE_N, dt, seed=M))


def _emulate_heads(plan, dt, xn, wn, ctas=None):
    """score::run with the head axis in numpy: CTA (b, h) is the one-head
    body on head h's (K, NH) weights, its outputs at columns h*NH on."""
    nh = plan.nh
    one = dataclasses.replace(plan, N=nh, heads=1)
    return np.concatenate([_emulate(one, dt, xn, wn[:, h * nh:(h + 1) * nh],
                                    ctas) for h in range(plan.heads)], axis=1)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("heads", [2, 3, 8])
def test_widened_heads_equal_each_head_alone(heads, dt):
    """Each head's (M, 105) block of the widened product equals, bit for
    bit, that head scored alone on the one-head plan (the emulated CTAs:
    first, middle, last of the widened grid; every row at the smallest
    level), and the plain version of the widened product within
    chip_smoke.py's limits (int8 exactly)."""
    for M in LEVELS["640x480"]:
        plan = sm.score_plan(M, N * heads, DTYPES[dt], heads=heads)
        xn, wn, xt, wt = _operands(M, K, N * heads, dt, seed=M + heads)
        ctas = None if M == LEVELS["640x480"][-1] else \
            sorted({0, plan.grid // 2, plan.grid - 1})
        got = _emulate_heads(plan, dt, xn, wn, ctas)
        rows = np.concatenate([np.arange(*plan.span(c)) for c in (
            ctas if ctas is not None else range(plan.grid))])
        single = sm.score_plan(M, N, DTYPES[dt])
        cover = [s for s in range(single.grid)
                 if single.span(s)[0] < rows.max() + 1
                 and single.span(s)[1] > rows.min()]
        for h in range(heads):
            alone = _emulate(single, dt, xn, wn[:, h * N:(h + 1) * N], cover)
            np.testing.assert_array_equal(got[rows, h * N:(h + 1) * N],
                                          alone[rows])
        if dt == "int8":
            np.testing.assert_array_equal(
                got[rows], sm.score_matmul_int8_plain(xt[rows], wt).numpy())
        else:
            np.testing.assert_allclose(
                got[rows], sm.score_matmul_plain(xt[rows], wt).numpy(),
                rtol=0, atol=chip_smoke.MATMUL_ATOL[dt])


def test_vec_flags_with_heads():
    """A head's 105 columns start at h * 420 bytes (f32 outputs, f32
    weights), off the 16-byte grid: its weights and outputs go element by
    element; heads of 128 columns keep their 16-byte copies, and so does
    one head of any width."""
    x = torch.zeros((133, K))
    for heads, nh, want in ((3, 105, sm.VEC_X), (2, 128, 7), (1, 315, 7)):
        w = torch.zeros((K, nh * heads))
        out = torch.zeros((133, nh * heads))
        assert sm.vec_flags(x, w, out, heads) == want
    # int8 weights of 16 columns a head fill whole chunks; the int32
    # outputs of 16 columns do too
    w8 = torch.zeros((K, 32), dtype=torch.int8)
    assert sm.vec_flags(torch.zeros((8, K), dtype=torch.int8), w8,
                        torch.zeros((8, 32), dtype=torch.int32), 2) == 7


def test_widened_shapes_the_kernel_does_not_take():
    """N must split into the heads, each of at most 128 columns; the
    wrappers refuse the rest on any device, naming the limit."""
    with pytest.raises(ValueError, match="plan"):
        sm.score_plan(4524, 316, torch.float32, heads=3)
    with pytest.raises(ValueError, match="128 columns"):
        sm.score_plan(4524, 129 * 2, torch.float32, heads=2)
    x = torch.zeros((8, K))
    with pytest.raises(ValueError, match="128 columns a head"):
        sm.score_matmul(x, torch.zeros((K, 210)))
    with pytest.raises(ValueError, match="split"):
        sm.score_matmul(x, torch.zeros((K, 210)), heads=4)
    got = sm.score_matmul(x, torch.zeros((K, 210)), heads=2)
    assert got.shape == (8, 210)
    q = torch.zeros((8, K), dtype=torch.int8)
    with pytest.raises(ValueError, match="128 columns a head"):
        sm.score_matmul_int8(q, torch.zeros((K, 315), dtype=torch.int8))
    assert sm.score_matmul_int8(q, torch.zeros((K, 315), dtype=torch.int8),
                                heads=3).shape == (8, 315)
