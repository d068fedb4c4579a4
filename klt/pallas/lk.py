"""One pyramid level of LK tracking as one Pallas kernel for NVIDIA GPUs.

The design follows the reference's CUDA tracker, V3 `trackFeaturesKernel`
(src/V3/trackFeaturesGPU.cu:191-281): each feature's whole Newton loop
runs on the device and samples the level images directly.  The launch
shape differs: one Triton program tracks a block of FB features (the
reference launches one thread per block), so every warp lane does work.

Per program:

* the per-feature state (position, status, iteration count, done flag)
  stays in registers for the whole level;
* the window is padded to power-of-two sides (7x7 -> 8x8) and the extra
  lanes are masked out of every sum;
* the four bilinear taps of all three channels (intensity, gradx,
  grady) are gathered straight from the level's [S, 3, H, W] f32 stack
  in device memory through integer index arrays (a 640x480 level stack
  is 3.7 MB and stays L2-resident);
* the first-image windows are sampled once per level;
* the Newton loop runs inside the kernel until every lane of the block
  is done or max_iterations is reached.

The status logic is ops/lk.py's `_track_level_gather` in the same order:
OOB before every update, SMALL_DET, convergence, then MAX_ITERATIONS and
the final residue check.  There is no matmul; window sums run in f32 in
another order than XLA's, so positions agree with the plain path to
~1e-5 px, not bit for bit.

`S` is the number of sequences: the single-stream driver passes S=1 and
the batched driver tracks [B*F] lanes in one launch, each lane carrying
its sequence index.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import (TrackingConfig, TRACKED, SMALL_DET, MAX_ITERATIONS,
                      OOB, LARGE_RESIDUE)

# features x padded-window lanes per program: 32 features of an 8x8
# window.  Larger windows get proportionally fewer features per program
# so that register use per program stays the same.  2048 lanes on 8
# warps was the fastest launch shape of those swept on the H100, in all
# three cells it was timed on (PERF.md).
LANES_PER_PROGRAM = 2048
NUM_WARPS = 8
_EPS = np.float32(1.001)  # rounding-error margin (src/V1/trackFeatures.c:409)


def _pow2(v: int) -> int:
    return 1 << max(0, int(v - 1).bit_length())


def feature_block(cfg: TrackingConfig) -> int:
    """Features per program for cfg's window (a power of two)."""
    wp = _pow2(cfg.window_width) * _pow2(cfg.window_height)
    return max(1, LANES_PER_PROGRAM // wp)


def _kernel(x1_ref, y1_ref, x2_ref, y2_ref, act_ref, seq_ref,
            st1_ref, st2_ref,
            xo_ref, yo_ref, so_ref, io_ref, *,
            cfg: TrackingConfig, nr: int, nc: int):
    w, h = cfg.window_width, cfg.window_height
    pw, ph = _pow2(w), _pow2(h)
    hwi, hhi = w // 2, h // 2
    hw, hh = np.float32(hwi), np.float32(hhi)
    ncf, nrf = np.float32(nc), np.float32(nr)
    plane = nr * nc
    area = np.float32(w * h)
    th = np.float32(cfg.min_displacement)
    step = np.float32(cfg.step_factor)

    k = jnp.arange(pw * ph, dtype=jnp.int32)
    ii = (k % pw)[None, :]
    jj = (k // pw)[None, :]
    valid = (ii < w) & (jj < h)                       # [1, WP]

    x1 = x1_ref[...]
    y1 = y1_ref[...]
    x2in = x2_ref[...]
    y2in = y2_ref[...]
    active = act_ref[...] != 0
    base = seq_ref[...] * (3 * plane)                 # [FB]

    def masked(v):
        return jnp.where(valid, v, jnp.float32(0.0))

    def window_oob(x, y):
        return ((x - hw < 0.0) | (ncf - (x + hw) < _EPS) |
                (y - hh < 0.0) | (nrf - (y + hh) < _EPS))

    def sample(ref, x, y, channels):
        """Bilinear windows at (x + i - hw, y + j - hh), in the
        reference's blend order (src/V1/trackFeatures.c:53-56)."""
        xt = x.astype(jnp.int32)
        yt = y.astype(jnp.int32)
        ax = (x - xt.astype(jnp.float32))[:, None]
        ay = (y - yt.astype(jnp.float32))[:, None]
        # clamping only moves reads of lanes whose window is out of
        # bounds, which the OOB checks retire before any update
        col = jnp.clip(xt[:, None] - hwi + ii, 0, nc - 2)
        row = jnp.clip(yt[:, None] - hhi + jj, 0, nr - 2)
        idx = base[:, None] + row * nc + col             # [FB, WP]
        out = []
        for c in channels:
            i00 = idx + c * plane
            p00 = ref[i00]
            p01 = ref[i00 + 1]
            p10 = ref[i00 + nc]
            p11 = ref[i00 + nc + 1]
            out.append(masked((1 - ax) * (1 - ay) * p00 +
                              ax * (1 - ay) * p01 +
                              (1 - ax) * ay * p10 +
                              ax * ay * p11))
        return out

    def rsum(v):
        return jnp.sum(v, axis=1)

    g1, gx1, gy1 = sample(st1_ref, x1, y1, (0, 1, 2))

    def intensity_diff(g2):
        if not cfg.lighting_insensitive:
            return g1 - g2
        # gain/bias-normalised difference (src/V1/trackFeatures.c:133-169)
        alpha = jnp.sqrt((rsum(g1 * g1) / area) / (rsum(g2 * g2) / area))
        beta = rsum(g1) / area - alpha * (rsum(g2) / area)
        return masked(g1 - g2 * alpha[:, None] - beta[:, None])

    def newton_step(g2, gx2, gy2):
        diff = intensity_diff(g2)
        if cfg.lighting_insensitive:
            # the reference's gain for gradients comes from plain means
            # (src/V1/trackFeatures.c:180-220)
            alpha = jnp.sqrt((rsum(g1) / area) / (rsum(g2) / area))[:, None]
            gx = gx1 + gx2 * alpha
            gy = gy1 + gy2 * alpha
        else:
            gx = gx1 + gx2
            gy = gy1 + gy2
        gxx = rsum(gx * gx)
        gxy = rsum(gx * gy)
        gyy = rsum(gy * gy)
        ex = rsum(diff * gx) * step
        ey = rsum(diff * gy) * step
        det = gxx * gyy - gxy * gxy
        small = det < np.float32(cfg.min_determinant)
        det_safe = jnp.where(small, jnp.float32(1.0), det)
        dx = (gyy * ex - gxy * ey) / det_safe
        dy = (gxx * ey - gxy * ex) / det_safe
        return dx, dy, small

    oob1 = window_oob(x1, y1)
    zero = jnp.zeros(active.shape, jnp.int32)

    def cond(state):
        it, _, _, _, _, done = state
        return (it < cfg.max_iterations) & (jnp.min(done) == 0)

    def body(state):
        it, x2c, y2c, status, iters, done = state
        notdone = done == 0
        oob = oob1 | window_oob(x2c, y2c)
        status = jnp.where(notdone & oob, OOB, status)
        notdone = notdone & ~oob
        g2, gx2, gy2 = sample(st2_ref, x2c, y2c, (0, 1, 2))
        dx, dy, small = newton_step(g2, gx2, gy2)
        status = jnp.where(notdone & small, SMALL_DET, status)
        upd = notdone & ~small
        x2c = x2c + jnp.where(upd, dx, jnp.float32(0.0))
        y2c = y2c + jnp.where(upd, dy, jnp.float32(0.0))
        iters = iters + upd.astype(jnp.int32)
        conv = (jnp.abs(dx) < th) & (jnp.abs(dy) < th)
        done = jnp.where(upd & ~conv, 0, 1)
        return it + 1, x2c, y2c, status, iters, done

    state = (jnp.int32(0), x2in, y2in, zero + TRACKED, zero,
             jnp.where(active, 0, 1))
    _, x2f, y2f, status, iters, _ = jax.lax.while_loop(cond, body, state)

    (g2,) = sample(st2_ref, x2f, y2f, (0,))
    residue = rsum(jnp.abs(intensity_diff(g2))) / area
    status = jnp.where(window_oob(x2f, y2f), OOB, status)
    status = jnp.where((status == TRACKED) &
                       (residue > np.float32(cfg.max_residue)),
                       LARGE_RESIDUE, status)
    status = jnp.where((status == TRACKED) & (iters >= cfg.max_iterations),
                       MAX_ITERATIONS, status)

    xo_ref[...] = jnp.where(active, x2f, x2in)
    yo_ref[...] = jnp.where(active, y2f, y2in)
    so_ref[...] = jnp.where(active, status, TRACKED)
    io_ref[...] = iters


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def track_level_lanes(stack1, stack2, x1, y1, x2, y2, active, seq,
                      cfg: TrackingConfig, interpret: bool = False):
    """One level for N feature lanes of S sequences.

    stack1/stack2: [S, 3, H, W] f32 (intensity, gradx, grady) of the two
    frames; x1..y2 f32 [N]; active bool [N]; seq int32 [N] sequence
    index of each lane.  Returns (x2, y2, status, iters), each [N],
    with ops.lk.track_level's contract.  `interpret` runs the kernel
    through the Pallas interpreter (CPU tests); it is never chosen by
    the tracking path.
    """
    s, c, nr, nc = stack1.shape
    assert c == 3 and stack2.shape == stack1.shape
    n = x1.shape[0]
    fb = feature_block(cfg)
    npad = -(-n // fb) * fb

    def pad(v, fill):
        return jnp.pad(v, (0, npad - n), constant_values=fill)

    lanes = (pad(x1, 0.0), pad(y1, 0.0), pad(x2, 0.0), pad(y2, 0.0),
             pad(active.astype(jnp.int32), 0),
             pad(seq.astype(jnp.int32), 0))
    flat1 = stack1.reshape(-1)
    flat2 = stack2.reshape(-1)

    lane_spec = pl.BlockSpec((fb,), lambda i: (i,))
    image_spec = pl.BlockSpec(flat1.shape, lambda i: (0,))
    out_shape = (jax.ShapeDtypeStruct((npad,), jnp.float32),
                 jax.ShapeDtypeStruct((npad,), jnp.float32),
                 jax.ShapeDtypeStruct((npad,), jnp.int32),
                 jax.ShapeDtypeStruct((npad,), jnp.int32))
    outs = pl.pallas_call(
        functools.partial(_kernel, cfg=cfg, nr=nr, nc=nc),
        out_shape=out_shape,
        grid=(npad // fb,),
        in_specs=[lane_spec] * 6 + [image_spec] * 2,
        out_specs=(lane_spec,) * 4,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="klt_lk_level",
    )(*lanes, flat1, flat2)
    return tuple(o[:n] for o in outs)
