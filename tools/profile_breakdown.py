"""Breakdown of per-frame-pair cost on device: pyramids vs LK levels.

Times three whole-sequence device programs (30 reps each, like bench.py)
so dispatch latency amortizes:
  A. pyramid build only (scan over frames)
  B. pyramids + LK at the coarsest level only
  C. full pipeline (pyramids + all LK levels)  == bench.py's program
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp

import klt
from klt.config import TrackingConfig
from klt.ops.pyramid import build_image_pyramids
from klt.ops.lk import track_features_pyramid, track_level


def timed(fn, *args, reps=3):
    r = fn(*args)
    jax.block_until_ready(r)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        r = fn(*args)
        jax.block_until_ready(r)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    klt.set_verbosity(0)
    cfg = TrackingConfig(sequential_mode=True)
    data = "/root/reference/data/images_provided"
    frames = np.stack([klt.read_pgm(os.path.join(data, f"img{i}.pgm"))
                       for i in range(10)])
    tracker = klt.KLTracker(cfg)
    fl = klt.FeatureList.create(150)
    tracker.select_good_features(frames[0], fl)

    frames_dev = jax.device_put(frames)
    x0 = jax.device_put(fl.x)
    y0 = jax.device_put(fl.y)
    v0 = jax.device_put(fl.val)
    n_pairs = frames.shape[0] - 1
    reps = 30

    def pyr(img):
        p, gx, gy = build_image_pyramids(img, cfg)
        return tuple(p), tuple(gx), tuple(gy)

    @jax.jit
    def prog_pyr_only(frames, x):
        def body(i, acc):
            def scanbody(carry, img):
                p, gx, gy = pyr(img + carry)
                return jnp.float32(0) * p[0][0, 0], (p[-1][0, 0])
            _, outs = jax.lax.scan(scanbody, jnp.float32(1e-4) * i, frames)
            return acc + outs.sum()
        return jax.lax.fori_loop(0, reps, body, jnp.float32(0))

    def make_prog_levels(levels):
        @jax.jit
        def prog(frames, x, y, v):
            def body(i, acc):
                def scanbody(carry, img):
                    (p1, x, y, v) = carry
                    p2 = pyr(img)
                    if levels == "all":
                        xn, yn, vn = track_features_pyramid(
                            list(p1[0]), list(p1[1]), list(p1[2]),
                            list(p2[0]), list(p2[1]), list(p2[2]),
                            x, y, v, cfg)
                    else:
                        r = levels
                        s1 = jnp.stack([p1[0][r], p1[1][r], p1[2][r]])
                        s2 = jnp.stack([p2[0][r], p2[1][r], p2[2][r]])
                        sc = np.float32(cfg.subsampling ** r)
                        xn, yn, st, _ = track_level(
                            s1, s2, x / sc, y / sc, x / sc, y / sc,
                            v >= 0, cfg)
                        xn, yn, vn = xn * sc, yn * sc, st
                    return (p2, xn, yn, vn), xn.sum()
                p0 = pyr(frames[0])
                (_, xf, _, _), outs = jax.lax.scan(
                    scanbody, (p0, x + 1e-4 * i, y, v), frames[1:])
                return acc + xf
            return jax.lax.fori_loop(0, reps, body, jnp.zeros_like(x))
        return prog

    t_pyr = timed(prog_pyr_only, frames_dev, x0) / (reps * 10)
    print(f"pyramid-only      : {t_pyr*1e6:8.1f} us/frame")
    for r in range(cfg.n_pyramid_levels):
        t = timed(make_prog_levels(r), frames_dev, x0, y0, v0) / (reps * n_pairs)
        print(f"pyr + level {r} LK  : {t*1e6:8.1f} us/pair")
    t_all = timed(make_prog_levels("all"), frames_dev, x0, y0, v0) / (reps * n_pairs)
    print(f"pyr + full LK     : {t_all*1e6:8.1f} us/pair")
    print(f"device: {jax.devices()[0]}")


if __name__ == "__main__":
    main()
