"""The port's tile planning (repro_torch.core.tiling) against the JAX
reference's (repro/core/tiling.py) on seeded numpy inputs.

Tap tables, planners and the top-k merge are exact. The banded resize
(band_rows / band_cols / resize_banded) is held bit for bit to the
reference's EAGER functions, whose every product and sum is its own
rounded f32 op, as the port's are; XLA:CPU contracts the jitted form into
fused multiply-adds, so against the reference's jit the differing pixels
are counted and printed (ROADMAP.md queue 3, deviations) and held within
four f32 ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import detector as jdet
from repro.core import tiling as jt
from repro.core.hog import PAPER_HOG as J_PAPER_HOG
from repro_torch.core import detector as tdet
from repro_torch.core import tiling as tt
from repro_torch.core.hog import PAPER_HOG

RNG = np.random.default_rng(26)

#: (src, dst) resizes: the test frames' levels, 640x480's, the UHD
#: bucket's rows at 0.8 and columns at 0.64, and an upscale
PAIRS = [(160, 128), (128, 102), (480, 384), (480, 307), (640, 409),
         (2176, 1740), (3840, 2457), (96, 130)]


@pytest.mark.parametrize("src,dst", PAIRS)
def test_band_weights_and_extension_equal_the_reference(src, dst):
    lo, w = tt.band_weights(src, dst)
    jlo, jw = jt.band_weights(src, dst)
    assert lo.dtype == jlo.dtype and w.dtype == jw.dtype
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(w, jw)
    ext = dst + 37
    for a, b in zip(tt.extend_band(lo, w, ext), jt.extend_band(jlo, jw, ext)):
        np.testing.assert_array_equal(a, b)
    assert tt.extend_band(lo, w, dst - 1)[0] is lo
    tlo, tw = tt.band_tensors(src, dst, ext, torch.device("cpu"))
    assert tlo.dtype == torch.int64 and tuple(tw.shape) == (ext, w.shape[1])
    np.testing.assert_array_equal(tw[dst:].numpy(), 0)


@pytest.mark.parametrize("h,w,sh,sw", [(160, 128, 128, 102),
                                       (480, 640, 307, 409),
                                       (192, 160, 192, 128),
                                       (96, 64, 130, 80)])
def test_banded_resize_is_the_reference_eager_bit_for_bit(h, w, sh, sw):
    """Two frames at once (a batch axis) against the reference, frame by
    frame; the jitted reference is counted, not required equal."""
    g = (RNG.random((2, h, w)) * 255).astype(np.float32)
    port = tt.resize_banded(torch.from_numpy(g), sh, sw).numpy()
    jit = jax.jit(jt.resize_banded, static_argnums=(1, 2))
    differ = 0
    for i in range(2):
        ref = np.asarray(jt.resize_banded(jnp.asarray(g[i]), sh, sw))
        np.testing.assert_array_equal(port[i], ref)
        fused = np.asarray(jit(jnp.asarray(g[i]), sh, sw))
        np.testing.assert_allclose(fused, ref, rtol=4 * 2.0 ** -23, atol=0)
        differ += int((fused != ref).sum())
    print(f"{h}x{w}->{sh}x{sw}: {differ} of {port.size} pixels differ "
          f"from the reference's jitted resize_banded")
    # each axis alone, through the port's band_rows / band_cols
    lo, wt = tt.band_weights(h, sh)
    g_pad = np.pad(g[0], ((0, wt.shape[1]), (0, 0)))
    rows = tt.band_rows(torch.from_numpy(g_pad), torch.from_numpy(lo).long(),
                        torch.from_numpy(wt)).numpy()
    np.testing.assert_array_equal(rows, np.asarray(jt.band_rows(
        jnp.asarray(g_pad), jnp.asarray(lo), jnp.asarray(wt))))
    lo, wt = tt.band_weights(w, sw)
    g_pad = np.pad(g[0], ((0, 0), (0, wt.shape[1])))
    cols = tt.band_cols(torch.from_numpy(g_pad), torch.from_numpy(lo).long(),
                        torch.from_numpy(wt)).numpy()
    np.testing.assert_array_equal(cols, np.asarray(jt.band_cols(
        jnp.asarray(g_pad), jnp.asarray(lo), jnp.asarray(wt))))


def test_banded_rows_and_columns_are_slice_invariant():
    """Any row slice of band_rows (any column slice of band_cols), from
    sliced tables, equals the same slice of the full output."""
    g = torch.from_numpy((RNG.random((2, 160, 128)) * 255).astype(np.float32))
    lo, w = tt.band_tensors(160, 128, 128, torch.device("cpu"))
    g_pad = torch.nn.functional.pad(g, (0, 0, 0, w.shape[1]))
    full = tt.band_rows(g_pad, lo, w)
    for a, b in [(0, 40), (37, 91), (100, 128), (5, 6)]:
        assert torch.equal(tt.band_rows(g_pad, lo[a:b], w[a:b]),
                           full[:, a:b])
    lo, w = tt.band_tensors(128, 102, 102, torch.device("cpu"))
    g_pad = torch.nn.functional.pad(g, (0, w.shape[1]))
    full = tt.band_cols(g_pad, lo, w)
    for a, b in [(0, 33), (50, 102), (7, 8)]:
        assert torch.equal(tt.band_cols(g_pad, lo[a:b], w[a:b]),
                           full[..., a:b])


@pytest.mark.parametrize("sph,fp", [(5, 2), (5, 8), (256, 4), (245, 3),
                                    (1, 1), (64, 64)])
def test_slab_planning_equals_the_reference(sph, fp):
    slab = tt.slab_rows(sph, fp)
    assert slab == jt.slab_rows(sph, fp)
    assert tt.slab_pixel_rows(slab, PAPER_HOG) == \
        jt.slab_pixel_rows(slab, J_PAPER_HOG)
    # the UHD bucket's level 1.0 over 4 tiles: slabs of 634 pixel rows
    assert tt.slab_pixel_rows(tt.slab_rows(256, 4), PAPER_HOG) == 634


@pytest.mark.parametrize("fp", [1, 2, 3, 4, 8])
def test_scale_groups_equal_the_reference(fp):
    for per_scale in (((1.0, 5, 9), (0.8, 3, 6), (0.5, 1, 2)),
                      ((1.0, 256, 471), (0.8, 199, 377), (0.64, 155, 300)),
                      ((1.0, 4, 4), (0.8, 4, 4), (0.64, 2, 8))):  # ties
        got = tt.scale_groups(per_scale, fp)
        assert got == jt.scale_groups(per_scale, fp)
        assert sorted(i for g in got for i in g) == list(range(3))


def _local_lists(s, fp, k, per_tile):
    """Each tile's stable local top-k over its contiguous index range."""
    n = len(s)
    locs, loci = [], []
    for d in range(fp):
        lo, hi = d * per_tile, min(n, (d + 1) * per_tile)
        part = np.concatenate([s[lo:hi], np.full(per_tile - (hi - lo),
                                                  -np.inf, np.float32)])
        ids = np.concatenate([np.arange(lo, hi),
                              np.full(per_tile - (hi - lo), n)])
        top, pos = tdet.top_k(torch.from_numpy(part), k)
        locs.append(top.numpy())
        loci.append(ids[pos.numpy()])
    return np.stack(locs), np.stack(loci)


@pytest.mark.parametrize("case", ["ties", "equal", "neg_inf", "few"])
def test_merge_topk_equals_the_reference_and_the_global_top_k(case):
    """Ties across tiles, every score equal (a zero-weight SVM scores the
    bias everywhere), -inf rows, and fewer real candidates than k; the
    port's merge against the reference's and against one top-k of the
    whole vector, with a batch axis of two."""
    n, k, fp, per_tile = 300, 32, 4, 80
    s = RNG.random(n).astype(np.float32)
    if case == "ties":
        s[50:60] = s[7]
        s[200:230] = s[7]
    elif case == "equal":
        s[:] = np.float32(0.25)
    elif case == "neg_inf":
        s[RNG.random(n) < 0.9] = -np.inf
    else:
        s[20:] = -np.inf
    batch_s, batch_i = [], []
    for b in range(2):
        v = s if b == 0 else s[::-1].copy()
        ls, li = _local_lists(v, fp, k, per_tile)
        js, ji = jt.merge_topk(jnp.asarray(ls), jnp.asarray(li), k)
        want_s, want_i = tdet.top_k(torch.from_numpy(v), k)
        np.testing.assert_array_equal(np.asarray(js), want_s.numpy())
        ms, mi = tt.merge_topk(torch.from_numpy(ls), torch.from_numpy(li), k)
        np.testing.assert_array_equal(ms.numpy(), np.asarray(js))
        np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
        if case != "few":
            np.testing.assert_array_equal(mi.numpy(), want_i.numpy())
        batch_s.append(ls)
        batch_i.append(li)
    bs, bi = tt.merge_topk(torch.from_numpy(np.stack(batch_s)),
                           torch.from_numpy(np.stack(batch_i)), k)
    for b in range(2):
        ms, mi = tt.merge_topk(torch.from_numpy(batch_s[b]),
                               torch.from_numpy(batch_i[b]), k)
        assert torch.equal(bs[b], ms) and torch.equal(bi[b], mi)


def test_auto_k_at_uhd_is_954():
    """3840x2160 pads to the 2176x3840 bucket: 244,026 window positions
    over three scales, auto-K 954, the same box table as the
    reference's."""
    cfg = tdet.DetectorConfig(pyramid_resize="banded")
    prog = tdet._frame_program(2176, 3840, cfg, torch.device("cpu"))
    ref = jdet._frame_program(2176, 3840, jdet.DetectorConfig(
        pyramid_resize="banded"))
    assert prog.n_positions == ref.n_positions == 244_026
    assert prog.k == ref.k == 954
    assert prog.per_scale == ref.per_scale
    np.testing.assert_array_equal(prog.boxes, ref.boxes)
    assert tdet._resolve_k(cfg, 244_026) == 954
    pinned = dataclasses.replace(cfg, max_detections=512)
    assert tdet._resolve_k(pinned, 244_026) == 512
    assert tdet._resolve_k(cfg, 60_000) == 256
    assert tdet._resolve_k(cfg, 100) == 100
