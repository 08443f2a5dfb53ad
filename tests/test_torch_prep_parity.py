"""The frame prep's parity with the JAX reference's jitted program, on the
CPU: the gray (repaired: core/hog.py:grayscale_fused), the resized levels
(open: the second resize product's summation order, which XLA:CPU runs
as a library dot at run time, not as an emitted loop) and the resize
weights off the 32-px grid (repaired: XLA's column-sum order,
core/detector.py:_xla_column_sum).

Run as a script, it prints the counts ROADMAP.md's queue 3 and PERF.md
cite, and the orders tried for both:

    PYTHONPATH=src python tests/test_torch_prep_parity.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import detector as jdet
from repro_torch.core import detector as tdet
from repro_torch.core import hog as thog
from repro_torch.data.synth_pedestrian import make_scene

f32 = np.float32
#: the quant + kernel case of tests/test_torch_session.py: a 192x128 frame
#: on its own bucket, seeded by the frame's size
SESSION_HW = (192, 128)


def _session_frame():
    h, w = SESSION_HW
    return make_scene(np.random.default_rng(h + w), h, w, n_people=1)[0]


def session_frame_counts():
    """Elements of the port's gray and of its two resized levels (scale 0.8
    and 0.64) that differ from the reference's jitted prep and resize on
    the seeded session frame, and the levels' whole-level (rint) flips,
    for the fused gray the port uses and the eager one it used before."""
    h, w = SESSION_HW
    frame = _session_frame()
    sizes = [(int(h * s), int(w * s)) for s in (0.8, 0.64)]
    weights = {sz: (jdet._resize_weights(h, sz[0]),
                    jdet._resize_weights(w, sz[1])) for sz in sizes}

    def reference(f):
        g = jdet._prep_frame(f, h, w, h, w)
        return [g] + [(jnp.asarray(wy) @ g) @ jnp.asarray(wx).T
                      for wy, wx in weights.values()]

    ref = [np.asarray(x) for x in jax.jit(reference)(jnp.asarray(frame))]
    prog = tdet.FrameDetector({"w": np.zeros(3780, f32), "b": f32(0)},
                              device="cpu").program_for(h, w)[0]
    out = {}
    for name, gray_fn in (("fused", thog.grayscale_fused),
                          ("eager", thog.grayscale)):
        g = gray_fn(torch.from_numpy(frame))
        levels = prog.pyramid(g)
        out[name] = [(int((l.numpy() != r).sum()),
                      int((np.rint(l.numpy()) != np.rint(r)).sum()), r.size)
                     for l, r in zip(levels, ref)]
    return out


def second_product_orders(buckets=((192, 128), (128, 192), (160, 224),
                                   (480, 640), (736, 1280))):
    """Entries of the second resize product x @ wx.T (x = wy @ gray, seeded
    uniform gray) that differ from XLA's in-program result, for torch's
    matmul and for products dealt to L lanes (k mod L, one product a lane
    as wx has at most 4 taps a column), then a pairwise or halving tree
    over the lanes. {(h, w, scale): {rule: mismatches}}."""
    rng = np.random.default_rng(0)
    out = {}
    for ph, pw in buckets:
        gray = rng.uniform(0, 255, (ph, pw)).astype(f32)
        for scale in (0.8, 0.64):
            wy = jdet._resize_weights(ph, int(ph * scale))
            wx = jdet._resize_weights(pw, int(pw * scale))
            x, ref = [np.asarray(a) for a in jax.jit(
                lambda g: ((jnp.asarray(wy) @ g),
                           (jnp.asarray(wy) @ g) @ jnp.asarray(wx).T))(
                jnp.asarray(gray))]
            rules = {"torch": (torch.from_numpy(x)
                               @ torch.from_numpy(wx).T).numpy()}
            for lanes in (4, 8, 16, 32, 64):
                for tree in ("pairwise", "halving"):
                    rules[f"L{lanes} {tree}"] = _lanes_rule(x, wx, lanes,
                                                            tree)
            out[ph, pw, scale] = {k: int((v != ref).sum())
                                  for k, v in rules.items()}
    return out


def _lanes_rule(x, wx, lanes, tree):
    M, K = x.shape
    vec = K - K % lanes
    out = np.zeros((M, wx.shape[0]), f32)
    for j in range(wx.shape[0]):
        acc = np.zeros((M, lanes), f32)
        rest = []
        for k in np.nonzero(wx[j])[0]:
            p = x[:, k] * wx[j, k]
            if k < vec:
                acc[:, k % lanes] = acc[:, k % lanes] + p
            else:
                rest.append(p)
        while acc.shape[1] > 1:
            half = acc.shape[1] // 2
            acc = (acc[:, 0::2] + acc[:, 1::2] if tree == "pairwise"
                   else acc[:, :half] + acc[:, half:])
        s = acc[:, 0]
        for p in rest:
            s = s + p
        out[:, j] = s
    return out


def column_sum_orders(pairs=((40, 32), (97, 78), (150, 120), (331, 264),
                             (577, 461), (1080, 864))):
    """Entries of _resize_weights(src, dst) off the 32-row grid that differ
    from the reference's for each column-sum order tried (the port's
    chunks of 32 among them). {(src, dst): {rule: mismatches}}."""
    out = {}
    for src, dst in pairs:
        ref = jdet._resize_weights(src, dst)
        inv = 1.0 / (dst / src)
        sf = ((np.arange(dst, dtype=f32) + f32(0.5)) * f32(inv) - f32(0.5))
        w = np.maximum(f32(0), f32(1) - np.abs(
            sf[None, :] - np.arange(src, dtype=f32)[:, None])
            / f32(max(inv, 1.0)))

        def finish(total):
            v = np.where(np.abs(total) > f32(1000.0 * np.finfo(f32).eps),
                         w / np.where(total != 0, total, f32(1)), f32(0))
            inside = (sf >= f32(-0.5)) & (sf <= f32(src - 0.5))
            return np.where(inside[None, :], v, f32(0)).T

        rules = {"sequential": _seq(w), "reverse": _seq(w[::-1]),
                 "xla windows of 32": tdet._xla_column_sum(w)}
        for c in (8, 16, 32, 64):
            parts = [_seq(w[i:i + c]) for i in range(0, src, c)]
            rules[f"chunks {c}, in order"] = _seq(np.array(parts))
            rules[f"chunks {c}, pairwise"] = _pairwise(parts)
        for lanes in (2, 4, 8, 16, 32, 64):
            vec = src - src % lanes
            acc = [_seq(w[l:vec:lanes]) for l in range(lanes)]
            rules[f"L{lanes} pairwise, rest after"] = _seq(np.array(
                [_pairwise(acc)] + list(w[vec:])))
        out[src, dst] = {k: int((finish(v[None, :]) != ref).sum())
                         for k, v in rules.items()}
    return out


def _seq(rows):
    total = np.zeros(rows.shape[1:], f32)
    for r in rows:
        total = total + r
    return total


def _pairwise(parts):
    parts = list(parts)
    while len(parts) > 1:
        nxt = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
        parts = nxt + ([parts[-1]] if len(parts) % 2 else [])
    return parts[0]


def test_session_frame_gray_is_the_jitted_reference():
    """The fused gray equals the reference's jitted gray on the session
    frame; the eager order it replaced does not."""
    counts = session_frame_counts()
    assert counts["fused"][0][:2] == (0, 0)
    assert counts["eager"][0][0] > 0
    # the levels still differ (the second product's order, queue 3)
    assert all(n > 0 for n, _, _ in counts["fused"][1:])


def test_port_column_sum_is_one_of_the_orders_tried():
    """The order the port uses, XLA's windows of 32 rows padded half
    before and half after (read from its optimized HLO), is exact on the
    grid (src 128) and off it, where every other order tried is not."""
    got = column_sum_orders(((128, 102),))[128, 102]
    assert got["chunks 32, in order"] == 0
    assert got["xla windows of 32"] == 0
    for key, rules in column_sum_orders().items():
        assert rules["xla windows of 32"] == 0, key
        assert min(n for r, n in rules.items()
                   if r != "xla windows of 32") > 0, key


if __name__ == "__main__":
    for name, rows in session_frame_counts().items():
        print(f"session frame, {name} gray: (differing, rint flips, size) "
              f"gray / level 0.8 / level 0.64: {rows}")
    for key, rules in column_sum_orders().items():
        print("resize weights", key, rules)
    for key, rules in second_product_orders().items():
        print("second product", key, rules)
