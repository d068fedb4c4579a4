"""Seeded synthetic sequences with known motion.

A smooth random texture is resampled (bilinearly) at a known sub-pixel
translation per frame, so every feature's true displacement is known
without a dataset or the C reference.  Used by `chip_smoke.py` and the
CPU tests; not a public API.
"""

from __future__ import annotations

import numpy as np


def _blur(a: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with edge replication."""
    r = int(3 * sigma + 0.5)
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    for axis in (0, 1):
        p = np.pad(a, [(r, r) if d == axis else (0, 0) for d in (0, 1)],
                   mode="edge")
        n = a.shape[axis]
        a = sum(k[i] * np.take(p, np.arange(i, i + n), axis=axis)
                for i in range(2 * r + 1))
    return a


def _bilinear(tex: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    ax = xs - x0
    ay = ys - y0
    return ((1 - ax) * (1 - ay) * tex[y0, x0] + ax * (1 - ay) * tex[y0, x0 + 1]
            + (1 - ax) * ay * tex[y0 + 1, x0] + ax * ay * tex[y0 + 1, x0 + 1])


def translated_sequence(n_frames: int, height: int, width: int, seed: int,
                        max_step: float = 1.5, sigma: float = 2.5):
    """(frames uint8 [T, H, W], motion f32 [T, 2]).

    motion[t] = (dx, dy): a point at (x, y) in frame 0 is at
    (x + dx, y + dy) in frame t (motion[0] = 0).  Per-frame steps are
    uniform in [-max_step, max_step] on each axis.
    """
    rng = np.random.default_rng(seed)
    steps = rng.uniform(-max_step, max_step, (n_frames, 2))
    steps[0] = 0.0
    motion = np.cumsum(steps, axis=0)
    margin = int(np.ceil(np.abs(motion).max())) + 4
    tex = _blur(rng.standard_normal((height + 2 * margin,
                                     width + 2 * margin)), sigma)
    tex = (tex - tex.mean()) / tex.std()
    tex = np.clip(128.0 + 45.0 * tex, 0.0, 255.0)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    frames = np.empty((n_frames, height, width), np.uint8)
    for t in range(n_frames):
        f = _bilinear(tex, xx - motion[t, 0] + margin,
                      yy - motion[t, 1] + margin)
        frames[t] = np.clip(np.rint(f), 0, 255).astype(np.uint8)
    return frames, motion.astype(np.float32)
