"""Synthetic pedestrian windows and scenes for the port's smoke runs and
tests.

A copy of the generators of repro/data/synth_pedestrian.py
(``make_windows``, ``make_dataset``, ``make_scene``, ``ClipConfig`` /
``make_clip`` and the helpers they draw from, numpy only), so the port needs nothing of the
reference package. The same ``rng`` state gives the same arrays as the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

H, W = 130, 66  # the paper's window


@dataclasses.dataclass(frozen=True)
class PedestrianDataConfig:
    n_pos: int = 4202            # paper's training split
    n_neg: int = 2795
    n_test_pos: int = 160        # paper's Table I eval split
    n_test_neg: int = 134
    noise_std: float = 26.0      # additive pixel noise (8-bit scale)
    min_contrast: float = 2.0    # person-vs-background luma gap (low = hard)
    max_contrast: float = 60.0
    occlusion_p: float = 0.65    # probability of a partial occluder
    distractor_strength: float = 1.2
    humanoid_neg_p: float = 0.18  # fraction of negatives that are person-like
    seed: int = 0


def _smooth_noise(rng: np.random.Generator, h: int, w: int,
                  scale: int = 8) -> np.ndarray:
    """Cheap Perlin-ish background: upsampled low-res noise."""
    small = rng.normal(size=(h // scale + 2, w // scale + 2))
    ys = np.linspace(0, small.shape[0] - 1.001, h)
    xs = np.linspace(0, small.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = ys - y0, xs - x0
    a = small[y0][:, x0]
    b = small[y0][:, x0 + 1]
    c = small[y0 + 1][:, x0]
    d = small[y0 + 1][:, x0 + 1]
    return (a * np.outer(1 - fy, 1 - fx) + b * np.outer(1 - fy, fx)
            + c * np.outer(fy, 1 - fx) + d * np.outer(fy, fx))


def _background(rng: np.random.Generator, cfg: PedestrianDataConfig) -> np.ndarray:
    base = rng.uniform(60, 190)
    grad = np.linspace(0, rng.uniform(-30, 30), H)[:, None]
    tex = _smooth_noise(rng, H, W, scale=int(rng.integers(6, 16))) * rng.uniform(5, 25)
    img = base + grad + tex
    # occasional horizon edge
    if rng.random() < 0.4:
        y = int(rng.integers(20, H - 20))
        img[y:] += rng.uniform(-35, 35)
    return img


def _ellipse_mask(h: int, w: int, cy: float, cx: float,
                  ry: float, rx: float) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0


def _person_mask(rng: np.random.Generator) -> np.ndarray:
    """Articulated silhouette in the 130x66 window, Dalal-style framing."""
    m = np.zeros((H, W), dtype=bool)
    scale = rng.uniform(0.82, 1.0)
    cx = W / 2 + rng.uniform(-6, 6)
    top = 14 + rng.uniform(-4, 6)

    head_r = 6.5 * scale * rng.uniform(0.85, 1.15)
    head_cy = top + head_r
    m |= _ellipse_mask(H, W, head_cy, cx + rng.uniform(-1.5, 1.5),
                       head_r, head_r * rng.uniform(0.8, 1.0))

    torso_top = head_cy + head_r * rng.uniform(0.7, 1.1)
    torso_h = 42 * scale * rng.uniform(0.9, 1.1)
    torso_w = 10.5 * scale * rng.uniform(0.85, 1.25)
    m |= _ellipse_mask(H, W, torso_top + torso_h / 2, cx,
                       torso_h / 2, torso_w)

    # arms: slight sway
    for side in (-1, 1):
        if rng.random() < 0.85:
            ax = cx + side * (torso_w + rng.uniform(0, 3.5))
            atop = torso_top + rng.uniform(0, 6)
            ah = torso_h * rng.uniform(0.7, 1.0)
            m |= _ellipse_mask(H, W, atop + ah / 2,
                               ax + side * rng.uniform(-1, 3),
                               ah / 2, 2.6 * scale)

    # legs: stride angle
    hip_y = torso_top + torso_h
    leg_h = min(H - 6 - hip_y, 50 * scale * rng.uniform(0.9, 1.05))
    spread = rng.uniform(1.5, 9.0)
    for side in (-1, 1):
        lx = cx + side * spread * rng.uniform(0.6, 1.2)
        m |= _ellipse_mask(H, W, hip_y + leg_h / 2, lx,
                           leg_h / 2, 3.4 * scale)
    return m


def _positive(rng: np.random.Generator, cfg: PedestrianDataConfig) -> np.ndarray:
    img = _background(rng, cfg)
    mask = _person_mask(rng)
    bg_mean = float(img[mask].mean()) if mask.any() else 128.0
    contrast = rng.uniform(cfg.min_contrast, cfg.max_contrast)
    sign = -1.0 if rng.random() < 0.5 else 1.0
    person_luma = np.clip(bg_mean + sign * contrast, 10, 245)
    # clothing split: torso vs legs can differ
    split_y = int(rng.uniform(60, 85))
    upper = mask & (np.arange(H)[:, None] < split_y)
    lower = mask & ~upper
    img[upper] = person_luma + rng.normal(0, 6)
    img[lower] = np.clip(person_luma + rng.uniform(-40, 40), 10, 245)
    # partial occluder (pole / bag) over the person
    if rng.random() < cfg.occlusion_p:
        x0 = int(rng.integers(8, W - 14))
        wd = int(rng.integers(4, 10))
        img[:, x0:x0 + wd] = rng.uniform(30, 220)
    return img


def _to_rgb(rng: np.random.Generator, gray: np.ndarray,
            noise_std: float) -> np.ndarray:
    """Give the luma image a mild random chroma + per-channel noise."""
    tint = rng.uniform(0.9, 1.1, size=3)
    rgb = np.stack([gray * t for t in tint], axis=-1)
    rgb += rng.normal(0, noise_std, size=rgb.shape)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _humanoid_negative(rng: np.random.Generator,
                       cfg: PedestrianDataConfig) -> np.ndarray:
    """Hard negative: person-like vertical structure that is NOT a person
    (mannequin-ish pole cluster / hydrant / narrow trunk pair). Excites the
    same vertical-edge bins as a pedestrian."""
    img = _background(rng, cfg)
    bg_mean = float(img.mean())
    luma = np.clip(bg_mean + rng.choice([-1, 1]) * rng.uniform(10, 60), 10, 245)
    cx = W / 2 + rng.uniform(-8, 8)
    # a head-ish blob at a WRONG height or proportion
    if rng.random() < 0.7:
        cy = rng.uniform(10, 50)
        r = rng.uniform(3, 12)
        img[_ellipse_mask(H, W, cy, cx + rng.uniform(-6, 6), r,
                          r * rng.uniform(0.5, 1.6))] = luma
    # a single wide trunk or two parallel bars (leg-like but rigid)
    if rng.random() < 0.5:
        wd = rng.uniform(4, 9)
        img[_ellipse_mask(H, W, H * 0.65, cx, H * 0.38, wd)] = luma
    else:
        for side in (-1, 1):
            img[_ellipse_mask(H, W, H * 0.65, cx + side * rng.uniform(3, 7),
                              H * 0.38, rng.uniform(2.2, 4.0))] = luma
    return img


def _negative(rng: np.random.Generator, cfg: PedestrianDataConfig) -> np.ndarray:
    if rng.random() < cfg.humanoid_neg_p:
        return _humanoid_negative(rng, cfg)
    img = _background(rng, cfg)
    s = cfg.distractor_strength
    kind = rng.integers(0, 4)
    if kind == 0:      # vertical bars: trunks / poles (hard negatives)
        for _ in range(int(rng.integers(1, 4))):
            x0 = int(rng.integers(0, W - 8))
            wd = int(rng.integers(3, 12))
            img[:, x0:x0 + wd] += rng.uniform(-70, 70) * s
    elif kind == 1:    # blobs (bushes, rocks)
        for _ in range(int(rng.integers(2, 6))):
            cy, cx = rng.uniform(10, H - 10), rng.uniform(5, W - 5)
            ry, rx = rng.uniform(5, 25), rng.uniform(4, 18)
            mask = _ellipse_mask(H, W, cy, cx, ry, rx)
            img[mask] += rng.uniform(-60, 60) * s
    elif kind == 2:    # building edges: rectangles
        for _ in range(int(rng.integers(1, 3))):
            y0, x0 = int(rng.integers(0, H - 20)), int(rng.integers(0, W - 15))
            hh, ww = int(rng.integers(15, 60)), int(rng.integers(10, 40))
            img[y0:y0 + hh, x0:x0 + ww] += rng.uniform(-55, 55) * s
    # kind == 3: pure textured background
    return img


def make_windows(n_pos: int, n_neg: int, cfg: PedestrianDataConfig,
                 rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    xs = np.empty((n_pos + n_neg, H, W, 3), dtype=np.uint8)
    ys = np.concatenate([np.ones(n_pos, np.int32), np.zeros(n_neg, np.int32)])
    for i in range(n_pos):
        xs[i] = _to_rgb(rng, _positive(rng, cfg), cfg.noise_std)
    for i in range(n_neg):
        xs[n_pos + i] = _to_rgb(rng, _negative(rng, cfg), cfg.noise_std)
    perm = rng.permutation(len(ys))
    return xs[perm], ys[perm]


def make_dataset(cfg: PedestrianDataConfig = PedestrianDataConfig()):
    """Returns (x_train, y_train, x_test, y_test) with the paper's split sizes."""
    rng = np.random.default_rng(cfg.seed)
    x_tr, y_tr = make_windows(cfg.n_pos, cfg.n_neg, cfg, rng)
    x_te, y_te = make_windows(cfg.n_test_pos, cfg.n_test_neg, cfg, rng)
    return x_tr, y_tr, x_te, y_te


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    """Synthetic video clip: pedestrians walking across a static
    cluttered background with constant-velocity motion + jitter."""

    n_frames: int = 16
    h: int = 240
    w: int = 320
    n_people: int = 2
    speed: float = 4.0          # px/frame trajectory magnitude (per axis)
    jitter: float = 0.6         # per-frame gaussian position jitter (px)
    frame_noise: float = 8.0    # per-frame pixel noise (temporal flicker)
    n_distractors: int = 3      # static clutter blobs/bars in the bg


def make_clip(rng: np.random.Generator,
              cfg: ClipConfig = ClipConfig()):
    """Video clip for the batched/tracking path.

    Each pedestrian keeps ONE rendered appearance for the whole clip
    and moves on a constant-velocity trajectory (chosen so the full
    path stays in-frame) with small gaussian jitter; the background and
    its clutter are static, only per-frame sensor noise changes. This
    is the workload the tracker's constant-velocity prediction and the
    batched detector are built for.

    Returns (frames, truths): frames (T, H, W, 3) uint8, truths[t] a
    list of {"id": person, "box": (y0, x0, y1, x1)} per frame.
    """
    pcfg = PedestrianDataConfig()
    h, w, T = cfg.h, cfg.w, cfg.n_frames
    if h < H or w < W:
        raise ValueError(f"clip frames must fit the {H}x{W} window, "
                         f"got ({h}, {w})")
    bg = _smooth_noise(rng, h, w, 12) * 20 + rng.uniform(70, 170)
    for _ in range(cfg.n_distractors):          # static clutter
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(8, 40), rng.uniform(5, 25)
        bg[_ellipse_mask(h, w, cy, cx, ry, rx)] += rng.uniform(-50, 50)
    bg = np.clip(bg, 0, 255)

    sprites, starts, vels = [], [], []
    for _ in range(cfg.n_people):
        sprites.append(_positive(rng, pcfg))
        v = rng.uniform(-cfg.speed, cfg.speed, size=2)
        # start uniformly inside the interval that keeps the whole
        # trajectory in-bounds; shrink the velocity if none exists
        pos = np.empty(2)
        for ax, lim in ((0, h - H), (1, w - W)):
            travel = v[ax] * (T - 1)
            lo, hi = max(0.0, -travel), min(lim, lim - travel)
            if lo > hi:
                v[ax] = np.sign(v[ax]) * lim / (T - 1)
                travel = v[ax] * (T - 1)
                lo, hi = max(0.0, -travel), min(lim, lim - travel)
            pos[ax] = rng.uniform(lo, hi)
        starts.append(pos)
        vels.append(v)

    tint = rng.uniform(0.9, 1.1, size=3)        # constant chroma per clip
    frames = np.empty((T, h, w, 3), np.uint8)
    truths = []
    for t in range(T):
        scene = bg.copy()
        boxes = []
        for i in range(cfg.n_people):
            y, x = starts[i] + vels[i] * t + rng.normal(0, cfg.jitter, 2)
            y0 = int(np.clip(round(y), 0, h - H))
            x0 = int(np.clip(round(x), 0, w - W))
            scene[y0:y0 + H, x0:x0 + W] = sprites[i]
            boxes.append({"id": i,
                          "box": (float(y0), float(x0),
                                  float(y0 + H), float(x0 + W))})
        rgb = np.stack([scene * c for c in tint], axis=-1)
        rgb += rng.normal(0, cfg.frame_noise, size=rgb.shape)
        frames[t] = np.clip(rgb, 0, 255).astype(np.uint8)
        truths.append(boxes)
    return frames, truths


def make_scene(rng: np.random.Generator, h: int = 320, w: int = 240,
               n_people: int = 2,
               region: Tuple[int, int, int, int] = None
               ) -> Tuple[np.ndarray, list]:
    """A larger scene with pasted pedestrians, for the sliding-window
    detector example. Returns (rgb uint8 (h,w,3), list of (y,x,130,66)
    boxes). `region` = (y0, x0, y1, x1) confines the paste positions to
    a sub-rectangle -- the cascade bench (benchmarks/bench_timing.py)
    uses it to build CLUSTERED scenes where people occupy one corner of
    an otherwise empty frame, the sparse-traffic shape the coarse-reject
    stage is built for."""
    cfg = PedestrianDataConfig()
    base = _background(rng, cfg)
    scene = np.clip(base + _smooth_noise(rng, h, w, 12)[:h, :w] * 10
                    if base.shape == (h, w) else
                    _smooth_noise(rng, h, w, 12) * 20 + rng.uniform(70, 170),
                    0, 255)
    ry0, rx0, ry1, rx1 = (0, 0, h, w) if region is None else region
    ry1 = min(ry1, h)
    rx1 = min(rx1, w)
    if ry1 - ry0 < H or rx1 - rx0 < W:
        raise ValueError(f"region {(ry0, rx0, ry1, rx1)} cannot fit one "
                         f"{H}x{W} window")
    boxes = []
    for _ in range(n_people):
        win = _positive(rng, cfg)
        y0 = int(rng.integers(ry0, ry1 - H)) if ry1 - ry0 > H else ry0
        x0 = int(rng.integers(rx0, rx1 - W)) if rx1 - rx0 > W else rx0
        scene[y0:y0 + H, x0:x0 + W] = win
        boxes.append((y0, x0, H, W))
    return _to_rgb(rng, scene, cfg.noise_std), boxes
