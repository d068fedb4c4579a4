"""Batched pyramidal Lucas-Kanade tracking.

Re-design of the reference's per-feature Newton loops (_trackFeature
src/V1/trackFeatures.c:381-486, driver KLTTrackFeatures :1234-1529): all
N features advance together as dense [N]-shaped arrays through a masked
iteration loop; masked lanes compute but do not update, in place of the
C code's data-dependent `break`s.

One level has three implementations with one contract
(`track_level`'s (x2, y2, status, iters)):

* on an NVIDIA GPU, the whole Newton loop of a level runs as one Pallas
  kernel (pallas/lk.py) that gathers its windows straight from the
  level images, as the reference's V3 CUDA tracker does;
* elsewhere, the XLA patch-resident path below: each feature gets a
  patch of the second image stack extracted by one-hot matmuls, windows
  are selected inside it by bilinear-weighted one-hot matmuls, and a
  feature that moves beyond its patch stalls until the level
  re-anchors its patch;
* `_track_level_gather`, per-iteration window gathers: the test oracle
  and the path for levels too small for a patch.

First-image windows are sampled once per level (the C code recomputes
them every iteration; same values), and the loops exit as soon as every
feature has converged or died.

Semantics preserved exactly:
* the do/while runs >= 1 iteration and <= max_iterations updates;
* OOB is checked (with the 1.001 epsilon margin) before every update and
  once more after the loop, and overrides any other status;
* SMALL_DET aborts before the update; convergence is |dx|<th AND |dy|<th;
* MAX_ITERATIONS is reported whenever the update budget was exhausted,
  even if the last step converged (src/V1/trackFeatures.c:483);
* SMALL_DET / OOB at a coarse level aborts the remaining levels and, like
  the C break, leaves the output coordinates at that level's scale for
  the final border classification (src/V1/trackFeatures.c:1378-1394);
* the lighting-insensitive variant replicates the reference's two distinct
  gain estimates (src/V1/trackFeatures.c:133-220, including the
  mislabeled accumulators).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (TrackingConfig, TRACKED, SMALL_DET, MAX_ITERATIONS,
                      OOB, LARGE_RESIDUE)
from ..pallas import lk_kernel_enabled
from ..pallas.lk import track_level_lanes
from .interp import (sample_stack_windows, onehot_extract,
                     select_windows_bilinear)

_EPS = np.float32(1.001)  # rounding-error margin (src/V1/trackFeatures.c:409)
PATCH_SIZE = 32           # per-feature resident patch side (f32 tile-friendly)


def _window_oob(x, y, hw, hh, nc, nr):
    """Window-out-of-bounds test, f32 arithmetic like the reference."""
    return ((x - hw < 0.0) | (nc - (x + hw) < _EPS) |
            (y - hh < 0.0) | (nr - (y + hh) < _EPS))


def _gain_bias_diff(g1, g2, area):
    """Gain/bias-normalized intensity difference
    (src/V1/trackFeatures.c:133-169)."""
    mean1 = jnp.sum(g1 * g1, axis=1) / area
    mean2 = jnp.sum(g2 * g2, axis=1) / area
    alpha = jnp.sqrt(mean1 / mean2)
    m1 = jnp.sum(g1, axis=1) / area
    m2 = jnp.sum(g2, axis=1) / area
    beta = m1 - alpha * m2
    return g1 - g2 * alpha[:, None] - beta[:, None]


def _gain_grad_sum(gx1w, gy1w, gx2w, gy2w, g1, g2, area):
    """Gain-normalized gradient sum.  The reference estimates this gain
    from plain-intensity means (src/V1/trackFeatures.c:180-220 — its
    accumulators are misnamed *_squared but sum raw values); replicated
    for behavioural parity."""
    mean1 = jnp.sum(g1, axis=1) / area
    mean2 = jnp.sum(g2, axis=1) / area
    alpha = jnp.sqrt(mean1 / mean2)[:, None]
    return gx1w + gx2w * alpha, gy1w + gy2w * alpha


def _newton_step(g1, gx1w, gy1w, g2, gx2w, gy2w, cfg: TrackingConfig):
    """One 2x2 normal-equation solve from sampled windows.

    Returns (dx, dy, small) — reference: _compute2by2GradientMatrix /
    _compute2by1ErrorVector / _solveEquation
    (src/V1/trackFeatures.c:227-307)."""
    area = np.float32(cfg.window_width * cfg.window_height)
    if cfg.lighting_insensitive:
        diff = _gain_bias_diff(g1, g2, area)
        gradx, grady = _gain_grad_sum(gx1w, gy1w, gx2w, gy2w, g1, g2, area)
    else:
        diff = g1 - g2
        gradx = gx1w + gx2w
        grady = gy1w + gy2w

    gxx = jnp.sum(gradx * gradx, axis=1)
    gxy = jnp.sum(gradx * grady, axis=1)
    gyy = jnp.sum(grady * grady, axis=1)
    step = np.float32(cfg.step_factor)
    ex = jnp.sum(diff * gradx, axis=1) * step
    ey = jnp.sum(diff * grady, axis=1) * step

    det = gxx * gyy - gxy * gxy
    small = det < np.float32(cfg.min_determinant)
    det_safe = jnp.where(small, jnp.float32(1.0), det)
    dx = (gyy * ex - gxy * ey) / det_safe
    dy = (gxx * ey - gxy * ex) / det_safe
    return dx, dy, small


def _final_status(status, iters, x2f, y2f, residue, hw, hh, ncf, nrf,
                  cfg: TrackingConfig):
    """Post-loop checks (src/V1/trackFeatures.c:459-484)."""
    final_oob = _window_oob(x2f, y2f, hw, hh, ncf, nrf)
    status = jnp.where(final_oob, OOB, status)
    status = jnp.where((status == TRACKED) &
                       (residue > np.float32(cfg.max_residue)),
                       LARGE_RESIDUE, status)
    status = jnp.where((status == TRACKED) & (iters >= cfg.max_iterations),
                       MAX_ITERATIONS, status)
    return status


def _track_level_gather(stack1, stack2, x1, y1, x2, y2, active,
                        cfg: TrackingConfig):
    """Reference implementation of one level: per-iteration window
    gathers.  Handles arbitrary displacements; used as the fallback when
    the patch-resident fast path overflows, and as the test oracle."""
    w, h = cfg.window_width, cfg.window_height
    hw, hh = np.float32(w // 2), np.float32(h // 2)
    nr, nc = stack1.shape[-2], stack1.shape[-1]
    ncf, nrf = np.float32(nc), np.float32(nr)
    th = np.float32(cfg.min_displacement)

    g1, gx1w, gy1w = sample_stack_windows(stack1, x1, y1, w, h)
    oob1 = _window_oob(x1, y1, hw, hh, ncf, nrf)

    status0 = jnp.full(x2.shape, TRACKED, jnp.int32)
    iters0 = jnp.zeros(x2.shape, jnp.int32)

    def iterate(state):
        k, x2c, y2c, status, iters, done = state
        oob = oob1 | _window_oob(x2c, y2c, hw, hh, ncf, nrf)
        status = jnp.where(~done & oob, OOB, status)
        done = done | oob

        g2, gx2w, gy2w = sample_stack_windows(stack2, x2c, y2c, w, h)
        dx, dy, small = _newton_step(g1, gx1w, gy1w, g2, gx2w, gy2w, cfg)
        status = jnp.where(~done & small, SMALL_DET, status)
        done = done | small

        upd = ~done
        x2c = x2c + jnp.where(upd, dx, 0.0)
        y2c = y2c + jnp.where(upd, dy, 0.0)
        iters = iters + upd.astype(jnp.int32)
        done = done | (upd & (jnp.abs(dx) < th) & (jnp.abs(dy) < th))
        return k + 1, x2c, y2c, status, iters, done

    def keep_going(state):
        k, _, _, _, _, done = state
        return (k < cfg.max_iterations) & jnp.any(~done)

    _, x2f, y2f, status, iters, _ = jax.lax.while_loop(
        keep_going, iterate,
        (jnp.int32(0), x2, y2, status0, iters0, ~active))

    g2, _, _ = sample_stack_windows(stack2, x2f, y2f, w, h)
    if cfg.lighting_insensitive:
        diff = _gain_bias_diff(g1, g2, np.float32(w * h))
    else:
        diff = g1 - g2
    residue = jnp.sum(jnp.abs(diff), axis=1) / np.float32(w * h)
    status = _final_status(status, iters, x2f, y2f, residue, hw, hh,
                           ncf, nrf, cfg)

    x2f = jnp.where(active, x2f, x2)
    y2f = jnp.where(active, y2f, y2)
    status = jnp.where(active, status, TRACKED)
    return x2f, y2f, status, iters


def track_level(stack1, stack2, x1, y1, x2, y2, active,
                cfg: TrackingConfig):
    """One pyramid level of batched LK.

    stack1/stack2: [3, H, W] f32 (intensity, gradx, grady) of the two
    frames at this level.  Lanes with active=False pass through untouched
    with status TRACKED.  Returns (x2_out, y2_out, status, iters).
    """
    w, h = cfg.window_width, cfg.window_height
    nr, nc = stack1.shape[-2], stack1.shape[-1]
    if nr < h + 1 or nc < w + 1:
        # level smaller than the tracking window: every window is
        # out of bounds before the first iteration (the reference's
        # first _window_oob check fails for all positions)
        status = jnp.where(active, jnp.int32(OOB), jnp.int32(TRACKED))
        return x2, y2, status, jnp.zeros_like(status)
    if lk_kernel_enabled():
        return track_level_lanes(stack1[None], stack2[None], x1, y1, x2, y2,
                                 active, jnp.zeros(x1.shape, jnp.int32),
                                 cfg=cfg)
    if min(nr, nc) < max(h, w) + 2:
        return _track_level_gather(stack1, stack2, x1, y1, x2, y2,
                                   active, cfg)

    hw, hh = np.float32(w // 2), np.float32(h // 2)
    hwi, hhi = w // 2, h // 2
    ncf, nrf = np.float32(nc), np.float32(nr)
    th = np.float32(cfg.min_displacement)
    sy = min(PATCH_SIZE, nr)
    sx = min(PATCH_SIZE, nc)

    # --- first-image windows: sampled once, integer-extract + blend ---
    xt1 = x1.astype(jnp.int32)
    yt1 = y1.astype(jnp.int32)
    ax1 = (x1 - xt1.astype(jnp.float32))[None, :, None]
    ay1 = (y1 - yt1.astype(jnp.float32))[None, :, None]
    x10 = jnp.clip(xt1 - hwi, 0, nc - (w + 1))
    y10 = jnp.clip(yt1 - hhi, 0, nr - (h + 1))
    w1 = onehot_extract(stack1, y10, x10, h + 1, w + 1)  # [F, 3, h+1, w+1]
    p00 = w1[:, :, :-1, :-1]
    p01 = w1[:, :, :-1, 1:]
    p10 = w1[:, :, 1:, :-1]
    p11 = w1[:, :, 1:, 1:]
    f = x1.shape[0]
    w1b = ((1 - ax1) * (1 - ay1) *
           p00.transpose(1, 0, 2, 3).reshape(3, f, h * w) +
           ax1 * (1 - ay1) * p01.transpose(1, 0, 2, 3).reshape(3, f, h * w) +
           (1 - ax1) * ay1 * p10.transpose(1, 0, 2, 3).reshape(3, f, h * w) +
           ax1 * ay1 * p11.transpose(1, 0, 2, 3).reshape(3, f, h * w))
    g1, gx1w, gy1w = w1b
    oob1 = _window_oob(x1, y1, hw, hh, ncf, nrf)

    # --- second-image resident patches, re-anchored on demand ---
    margin_y = (sy - (h + 1)) // 2
    margin_x = (sx - (w + 1)) // 2

    def anchors(x2c, y2c):
        py0 = jnp.clip(y2c.astype(jnp.int32) - hhi - margin_y, 0, nr - sy)
        px0 = jnp.clip(x2c.astype(jnp.int32) - hwi - margin_x, 0, nc - sx)
        return py0, px0

    def local_window(x2c, y2c, py0, px0):
        """Integer corner + fractions of the sampling window in patch
        coordinates, plus the out-of-patch overflow flag."""
        xt = x2c.astype(jnp.int32)
        yt = y2c.astype(jnp.int32)
        ax = x2c - xt.astype(jnp.float32)
        ay = y2c - yt.astype(jnp.float32)
        ox = xt - hwi - px0
        oy = yt - hhi - py0
        ovf = ((ox < 0) | (ox > sx - (w + 1)) |
               (oy < 0) | (oy > sy - (h + 1)))
        ox = jnp.clip(ox, 0, sx - (w + 1))
        oy = jnp.clip(oy, 0, sy - (h + 1))
        return oy, ox, ay, ax, ovf

    status0 = jnp.full(x2.shape, TRACKED, jnp.int32)
    iters0 = jnp.zeros(x2.shape, jnp.int32)

    def inner(state):
        """One Newton iteration; lanes beyond their patch stall so the
        outer loop can re-anchor them with exact samples."""
        x2c, y2c, status, iters, done, py0, px0, patches, _ = state
        oob = oob1 | _window_oob(x2c, y2c, hw, hh, ncf, nrf)
        status = jnp.where(~done & oob, OOB, status)
        done = done | oob

        oy, ox, ay, ax, ovf = local_window(x2c, y2c, py0, px0)
        stall = ~done & ovf
        eff = ~done & ~ovf

        g2, gx2w, gy2w = select_windows_bilinear(patches, oy, ox, ay, ax,
                                                 h, w)
        dx, dy, small = _newton_step(g1, gx1w, gy1w, g2, gx2w, gy2w, cfg)
        status = jnp.where(eff & small, SMALL_DET, status)
        done = done | (eff & small)

        upd = eff & ~small
        x2c = x2c + jnp.where(upd, dx, 0.0)
        y2c = y2c + jnp.where(upd, dy, 0.0)
        iters = iters + upd.astype(jnp.int32)
        converged = (jnp.abs(dx) < th) & (jnp.abs(dy) < th)
        done = done | (upd & (converged | (iters >= cfg.max_iterations)))
        return (x2c, y2c, status, iters, done, py0, px0, patches,
                jnp.any(stall))

    def inner_going(state):
        done, stalled = state[4], state[8]
        return jnp.any(~done) & ~stalled

    def outer(state):
        rounds, x2c, y2c, status, iters, done = state
        py0, px0 = anchors(x2c, y2c)
        patches = onehot_extract(stack2, py0, px0, sy, sx)
        x2c, y2c, status, iters, done, _, _, _, _ = jax.lax.while_loop(
            inner_going, inner,
            (x2c, y2c, status, iters, done, py0, px0, patches,
             jnp.asarray(False)))
        return rounds + 1, x2c, y2c, status, iters, done

    def outer_going(state):
        rounds, done = state[0], state[5]
        # progress is guaranteed: a freshly anchored in-bounds lane can't
        # stall, so rounds is bounded by the stall count
        return jnp.any(~done) & (rounds < cfg.max_iterations + 2)

    _, x2f, y2f, status, iters, _ = jax.lax.while_loop(
        outer_going, outer,
        (jnp.int32(0), x2, y2, status0, iters0, ~active))

    # Residue at the final position, from freshly anchored patches
    # (a lane's last update may land outside its previous patch).
    py0, px0 = anchors(x2f, y2f)
    patches = onehot_extract(stack2, py0, px0, sy, sx)
    oy, ox, ay, ax, _ = local_window(x2f, y2f, py0, px0)
    g2, _, _ = select_windows_bilinear(patches, oy, ox, ay, ax, h, w)
    if cfg.lighting_insensitive:
        diff = _gain_bias_diff(g1, g2, np.float32(w * h))
    else:
        diff = g1 - g2
    residue = jnp.sum(jnp.abs(diff), axis=1) / np.float32(w * h)
    status = _final_status(status, iters, x2f, y2f, residue, hw, hh,
                           ncf, nrf, cfg)

    x2f = jnp.where(active, x2f, x2)
    y2f = jnp.where(active, y2f, y2)
    status = jnp.where(active, status, TRACKED)
    return x2f, y2f, status, iters


def track_features_pyramid(pyr1, gradx1, grady1, pyr2, gradx2, grady2,
                           x, y, val, cfg: TrackingConfig):
    """Coarse-to-fine tracking of all features between two pyramids.

    pyr*/grad* are finest-first lists of [H_l, W_l] f32 images.  x, y are
    f32[N] positions in frame 1; val i32[N] (lost features val<0 are
    skipped).  Returns (x_new, y_new, val_new) with the reference's
    classification (src/V1/trackFeatures.c:1343-1437): lost features get
    x = y = -1 and the failure code.
    """
    stacks1 = [jnp.stack([p, a, b])
               for p, a, b in zip(pyr1, gradx1, grady1)]
    stacks2 = [jnp.stack([p, a, b])
               for p, a, b in zip(pyr2, gradx2, grady2)]
    return track_features_pyramid_stacks(stacks1, stacks2, x, y, val, cfg)


def track_features_pyramid_stacks(stacks1, stacks2, x, y, val,
                                  cfg: TrackingConfig):
    """Same driver on finest-first [3, H_l, W_l] level stacks."""
    from ..utils.checks import check_in_bounds, check_same_shape
    nr0, nc0 = stacks1[0].shape[-2], stacks1[0].shape[-1]
    alive = val >= 0
    check_same_shape(stacks1[0], stacks2[0], "frame pair")
    check_in_bounds(jnp.where(alive, x, 0.0), jnp.where(alive, y, 0.0),
                    nc0, nr0, "input feature positions")
    return coarse_to_fine(track_level, stacks1, stacks2, x, y, val, cfg,
                          nr0, nc0)


def coarse_to_fine(level_fn, stacks1, stacks2, x, y, val,
                   cfg: TrackingConfig, nr0: int, nc0: int):
    """The reference's level walk and final classification
    (src/V1/trackFeatures.c:1343-1437), elementwise over lanes of any
    shape.  level_fn(stack1, stack2, x1, y1, x2, y2, active, cfg) tracks
    one level; nr0, nc0 are the finest level's dimensions."""
    s = np.float32(cfg.subsampling)
    nlev = cfg.n_pyramid_levels
    alive = val >= 0

    xloc, yloc = x, y
    for _ in range(nlev):
        xloc = xloc / s
        yloc = yloc / s
    xout, yout = xloc, yloc

    aborted = jnp.zeros_like(alive)
    last_status = jnp.full(x.shape, TRACKED, jnp.int32)

    for r in range(nlev - 1, -1, -1):
        in_loop = alive & ~aborted  # lanes still in the C level loop
        xloc = jnp.where(in_loop, xloc * s, xloc)
        yloc = jnp.where(in_loop, yloc * s, yloc)
        xout = jnp.where(in_loop, xout * s, xout)
        yout = jnp.where(in_loop, yout * s, yout)

        x2, y2, st, _ = level_fn(stacks1[r], stacks2[r], xloc, yloc,
                                 xout, yout, in_loop, cfg)

        xout = jnp.where(in_loop, x2, xout)
        yout = jnp.where(in_loop, y2, yout)
        last_status = jnp.where(in_loop, st, last_status)
        aborted = aborted | (in_loop & ((st == SMALL_DET) | (st == OOB)))

    # Final classification (src/V1/trackFeatures.c:1382-1437): a feature
    # that lands outside the border margin is recorded as OOB even if its
    # level status was something else.
    bx = np.float32(cfg.borderx)
    by = np.float32(cfg.bordery)
    out_of_border = ((xout < bx) | (xout > np.float32(nc0 - 1) - bx) |
                     (yout < by) | (yout > np.float32(nr0 - 1) - by))
    final = jnp.where((last_status != OOB) & out_of_border, OOB, last_status)

    lost = final != TRACKED
    x_new = jnp.where(alive, jnp.where(lost, jnp.float32(-1.0), xout), x)
    y_new = jnp.where(alive, jnp.where(lost, jnp.float32(-1.0), yout), y)
    val_new = jnp.where(alive, final, val)
    return x_new, y_new, val_new
