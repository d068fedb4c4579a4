"""Bit-exact (golden-replay) translation LK tier.

The slot-aligned replacement parity contract (a feature table whose
per-slot content matches the reference CPU tracker's over hundreds of
frames) cannot be met by a merely-accurate tracker: ONE borderline
kill decision (residue within ulps of max_residue, a determinant or
boundary comparison at the margin) makes the two runs refill a
different number of slots, and the first-lost-slot pick walk then
permutes every later binding (measured on images_traffic: a single
frame-2 status flip caps slot-frame agreement at ~51%).  The only
robust fix is a tracking tier whose every f32 operation rounds
IDENTICALLY to the reference's — then kill decisions, positions and
(with ops/replace_exact) replacement picks all match bit-for-bit.

This module is that tier: the reference's _trackFeature chain
(src/V1/trackFeatures.c:381-486) re-expressed as batched [N]-lane
tensor ops whose per-lane f32 rounding sequence equals the C scalar
loop's:

* pyramids/gradients via the C-ordered shift-FMA convolutions of
  ops/replace_exact;
* patch gathering via one-hot matmuls in HIGHEST precision, which is
  exact (every product is 0*x or 1*x);
* bilinear interpolation with the C expression's exact multiply
  grouping and left-to-right sum (src/V1/trackFeatures.c:54-57);
* window reductions as unrolled 49-step sequential add chains in
  row-major order (:227-279, :354-367);
* the do/while Newton loop with per-lane masks reproducing the C
  break/continue structure, status precedence and final residue
  check (:381-486), and the coarse-to-fine coordinate walk with its
  repeated /=subsampling then *=subsampling f32 scalings (:1352-1380
  — exact, subsampling is a power of two).

It is slower than the fast tier (sequential chains do not
vectorize across the window) and exists for the replacement/parity
configurations; the flagship configs keep the fast tier.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (TrackingConfig, TRACKED, SMALL_DET, MAX_ITERATIONS,
                      OOB, LARGE_RESIDUE)
from ..kernels import gaussian_kernels
from .replace_exact import _conv_h_exact, _conv_v_exact, _two_prod

_F32 = jnp.float32


def _div_cr(a, b):
    """Correctly-rounded f32 a/b.  A reciprocal-and-Newton divide is
    faithfully rounded but not always correctly rounded, while the C
    scalar '/' is.  One exact-residual correction of the
    hardware quotient: r = a - q0*b computed exactly (Dekker two_prod;
    a - p is exact by Sterbenz since p is within 1 ulp of a), then
    q0 + r/b rounds to the correctly-rounded quotient."""
    q0 = a / b
    p, e = _two_prod(q0, b)
    r = (a - p) - e
    return q0 + r / b


def _smooth_exact(img, sigma):
    g, _ = gaussian_kernels(sigma)
    return _conv_v_exact(_conv_h_exact(img, g), g)


def _gradients_exact(img, sigma):
    g, d = gaussian_kernels(sigma)
    gx = _conv_v_exact(_conv_h_exact(img, d), g)
    gy = _conv_v_exact(_conv_h_exact(img, g), d)
    return gx, gy


def build_pyramids_exact(frame, cfg: TrackingConfig):
    """Exact-order pyramid + gradient chain for one frame
    (src/V1/trackFeatures.c:1296-1321, pyramid.c:87-131).  Returns
    (imgs, gxs, gys): tuples of [H_l, W_l] f32, finest first."""
    fi = frame.astype(_F32)
    level0 = _smooth_exact(fi, cfg.smooth_sigma)
    ss = cfg.subsampling
    subhalf = ss // 2
    sigma = ss * cfg.pyramid_sigma_fact
    imgs = [level0]
    ncols, nrows = level0.shape[1], level0.shape[0]
    curr = level0
    for _ in range(1, cfg.n_pyramid_levels):
        tmp = _smooth_exact(curr, sigma)
        ncols //= ss
        nrows //= ss
        curr = tmp[subhalf::ss, subhalf::ss][:nrows, :ncols]
        imgs.append(curr)
    gxs, gys = [], []
    for im in imgs:
        gx, gy = _gradients_exact(im, cfg.grad_sigma)
        gxs.append(gx)
        gys.append(gy)
    return tuple(imgs), tuple(gxs), tuple(gys)


# ------------------------------------------------------------------ #
# exact batched interpolation                                         #
# ------------------------------------------------------------------ #

# patch margin: xt = (int)(x2 + i) can differ from (int)x2 + i by 1
# either way (the f32 add rounds), and the bilinear reads xt+1.
_PAT_MARGIN = 2


def _patch_size(win: int) -> int:
    return win + 2 * _PAT_MARGIN + 1


def _extract_patches3(stack3, bx, by, p: int):
    """[3, H, W] stacked (img, gx, gy) -> [N, 3, p, p] patches whose
    (0, 0) texel is (by, bx), via one-hot matmuls in HIGHEST precision,
    which is exact (every product is 0*x or 1*x)."""
    _, h, w = stack3.shape
    rows = by[:, None] + jnp.arange(p, dtype=jnp.int32)[None, :]  # [N,p]
    cols = bx[:, None] + jnp.arange(p, dtype=jnp.int32)[None, :]
    oy = (rows[:, :, None] == jnp.arange(h, dtype=jnp.int32)).astype(_F32)
    ox = (cols[:, :, None] == jnp.arange(w, dtype=jnp.int32)).astype(_F32)
    tmp = jnp.einsum("nph,chw->ncpw", oy, stack3,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=_F32)
    return jnp.einsum("ncpw,nqw->ncpq", tmp, ox,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=_F32)


def _bilerp_windows(patches, x, y, bx, by, win: int):
    """C-exact bilinear interpolation of a [win, win] window centered
    at (x, y) from per-lane patches [N, p, p] based at (by, bx).

    patches: dict name -> [N, p, p]; returns dict name -> [N, win, win]
    with each value bit-equal to _interpolate(x+i, y+j, img)
    (src/V1/trackFeatures.c:31-57)."""
    hw = win // 2
    offs = jnp.arange(-hw, hw + 1, dtype=jnp.int32).astype(_F32)
    cx = x[:, None] + offs[None, :]             # [N, win] f32 adds (C: x1+i)
    cy = y[:, None] + offs[None, :]
    xt = cx.astype(jnp.int32)                   # (int) cast, trunc
    yt = cy.astype(jnp.int32)
    ax = cx - xt.astype(_F32)
    ay = cy - yt.astype(_F32)
    px = xt - bx[:, None]                        # in-patch columns [N, win]
    py = yt - by[:, None]
    p = patches[next(iter(patches))].shape[-1]
    pxc = jnp.clip(px, 0, p - 2)
    pyc = jnp.clip(py, 0, p - 2)
    ex0 = (pxc[:, :, None] ==
           jnp.arange(p, dtype=jnp.int32)).astype(_F32)   # [N, win, p]
    ey0 = (pyc[:, :, None] ==
           jnp.arange(p, dtype=jnp.int32)).astype(_F32)
    ex1 = (pxc[:, :, None] + 1 ==
           jnp.arange(p, dtype=jnp.int32)).astype(_F32)
    ey1 = (pyc[:, :, None] + 1 ==
           jnp.arange(p, dtype=jnp.int32)).astype(_F32)

    one = _F32(1.0)
    w00 = ((one - ax)[:, None, :] * (one - ay)[:, :, None])  # [N, win, win]
    w01 = (ax[:, None, :] * (one - ay)[:, :, None])
    w10 = ((one - ax)[:, None, :] * ay[:, :, None])
    w11 = (ax[:, None, :] * ay[:, :, None])

    def corner(pat, ey, ex):
        t = jnp.einsum("njq,nqp->njp", ey, pat,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=_F32)
        return jnp.einsum("njp,nip->nji", t, ex,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=_F32)

    out = {}
    for name, pat in patches.items():
        c00 = corner(pat, ey0, ex0)
        c01 = corner(pat, ey0, ex1)
        c10 = corner(pat, ey1, ex0)
        c11 = corner(pat, ey1, ex1)
        # C expression: left-to-right sum of the four products, each
        # multiplied as ((wx * wy) * pixel)
        out[name] = ((w00 * c00 + w01 * c01) + w10 * c10) + w11 * c11
    return out


def _window_chain_sum(terms):
    """Sequential row-major f32 accumulation of a [N, win, win] term
    map — the C `for (i = 0; i < w*h; i++) acc += term[i]` chain."""
    n, wh, ww = terms.shape
    flat = terms.reshape(n, wh * ww)
    acc = flat[:, 0]
    for k in range(1, wh * ww):
        acc = acc + flat[:, k]
    return acc


# ------------------------------------------------------------------ #
# the per-level exact Newton loop                                     #
# ------------------------------------------------------------------ #

def _track_level_exact(img1, gx1, gy1, img2, gx2, gy2,
                       x1, y1, x2, y2, active, cfg: TrackingConfig):
    """Masked batched replica of _trackFeature
    (src/V1/trackFeatures.c:381-486) on one pyramid level.

    Returns (x2, y2, status) with status TRACKED/SMALL_DET/OOB/
    MAX_ITERATIONS/LARGE_RESIDUE per lane; inactive lanes untouched.
    """
    win_w, win_h = cfg.window_width, cfg.window_height
    assert win_w == win_h, "exact tier assumes square windows"
    win = win_w
    hw = win // 2
    p = _patch_size(win)
    nr, nc = img1.shape
    eps = _F32(1.001)
    small = _F32(cfg.min_determinant)
    th = _F32(cfg.min_displacement)
    step_factor = _F32(cfg.step_factor)
    max_iter = int(cfg.max_iterations)
    n = x1.shape[0]

    def in_bounds(x, y):
        # C: x-hw < 0 || nc-(x+hw) < 1.001 || same for y — note the
        # mixed int/f32 arithmetic order (hw, nc ints promoted to f32)
        return ~((x - _F32(hw) < _F32(0.0)) |
                 (_F32(nc) - (x + _F32(hw)) < eps) |
                 (y - _F32(hw) < _F32(0.0)) |
                 (_F32(nr) - (y + _F32(hw)) < eps))

    def base_of(x, y):
        bx = x.astype(jnp.int32) - hw - _PAT_MARGIN
        by = y.astype(jnp.int32) - hw - _PAT_MARGIN
        bx = jnp.clip(bx, 0, nc - p)
        by = jnp.clip(by, 0, nr - p)
        return bx, by

    st1 = jnp.stack([img1, gx1, gy1])
    st2 = jnp.stack([img2, gx2, gy2])

    # windows at (x1, y1) are iteration-invariant: hoist (the C loop
    # recomputes them each iteration with identical results)
    bx1, by1 = base_of(x1, y1)
    p1 = _extract_patches3(st1, bx1, by1, p)
    pat1 = {"img": p1[:, 0], "gx": p1[:, 1], "gy": p1[:, 2]}
    w1 = _bilerp_windows(pat1, x1, y1, bx1, by1, win)

    def sample2(x, y):
        bx, by = base_of(x, y)
        p2 = _extract_patches3(st2, bx, by, p)
        pat2 = {"img": p2[:, 0], "gx": p2[:, 1], "gy": p2[:, 2]}
        return _bilerp_windows(pat2, x, y, bx, by, win)

    def diff_windows(w2):
        return w1["img"] - w2["img"]  # C: g1 - g2 per pixel

    st0 = jnp.where(active, jnp.int32(TRACKED), jnp.int32(-9))
    state = (x2, y2, jnp.zeros(n, _F32), jnp.zeros(n, _F32),
             jnp.zeros(n, jnp.int32), st0,
             active & in_bounds(x1, y1) & in_bounds(x2, y2), jnp.int32(0))
    # lanes OOB on entry: C breaks before any update
    x2_, y2_, _, _, _, st0_, run0, _ = state
    st0 = jnp.where(active & ~run0, jnp.int32(OOB), st0)
    state = (x2_, y2_, state[2], state[3], state[4], st0, run0,
             jnp.int32(0))

    def cond(s):
        return jnp.any(s[6]) & (s[7] < max_iter)

    def body(s):
        x2, y2, dx, dy, iters, st, run, k = s
        w2 = sample2(x2, y2)
        imgdiff = diff_windows(w2)
        gradx = w1["gx"] + w2["gx"]   # C: g1 + g2
        grady = w1["gy"] + w2["gy"]
        # one stacked chain for all five window sums: each lane's add
        # sequence is unchanged (the stack widens the vector, not the
        # chain), but the scan body issues 49 ops instead of 245
        sums = _window_chain_sum(jnp.concatenate(
            [gradx * gradx, gradx * grady, grady * grady,
             imgdiff * gradx, imgdiff * grady]))
        gxx, gxy, gyy, ex, ey = jnp.split(sums, 5)
        ex = ex * step_factor
        ey = ey * step_factor
        det = gxx * gyy - gxy * gxy
        det_ok = det >= small
        det_safe = jnp.where(det_ok, det, _F32(1.0))
        ndx = _div_cr(gyy * ex - gxy * ey, det_safe)
        ndy = _div_cr(gxx * ey - gxy * ex, det_safe)
        st = jnp.where(run & ~det_ok, jnp.int32(SMALL_DET), st)
        upd = run & det_ok
        nx2 = jnp.where(upd, x2 + ndx, x2)
        ny2 = jnp.where(upd, y2 + ndy, y2)
        dx = jnp.where(upd, ndx, dx)
        dy = jnp.where(upd, ndy, dy)
        iters = jnp.where(upd, iters + 1, iters)
        # while ((|dx|>=th || |dy|>=th) && iteration < max_iterations)
        more = (jnp.abs(dx) >= th) | (jnp.abs(dy) >= th)
        run = upd & more & (iters < max_iter)
        # next iteration's top-of-loop OOB check
        oob_next = run & ~in_bounds(nx2, ny2)
        st = jnp.where(oob_next, jnp.int32(OOB), st)
        run = run & ~oob_next
        return nx2, ny2, dx, dy, iters, st, run, k + 1

    x2, y2, dx, dy, iters, st, run, _ = jax.lax.while_loop(
        cond, body, state)

    # post-loop: out-of-bounds overrides whatever the loop decided
    st = jnp.where(active & ~in_bounds(x2, y2), jnp.int32(OOB), st)

    # residue check for lanes still TRACKED (incl. iteration-capped)
    tracked = active & (st == jnp.int32(TRACKED))
    if cfg.max_residue > 0:
        w2f = sample2(jnp.where(tracked, x2, jnp.float32(hw + 2)),
                      jnp.where(tracked, y2, jnp.float32(hw + 2)))
        resid = _window_chain_sum(jnp.abs(diff_windows(w2f)))
        inv_area = _div_cr(resid, _F32(win * win))
        st = jnp.where(tracked & (inv_area > _F32(cfg.max_residue)),
                       jnp.int32(LARGE_RESIDUE), st)
    st = jnp.where(active & (st == jnp.int32(TRACKED)) &
                   (iters >= max_iter), jnp.int32(MAX_ITERATIONS), st)
    return x2, y2, st


def track_features_exact(pyr1, pyr2, x, y, val, cfg: TrackingConfig):
    """Bit-exact replica of KLTTrackFeatures' per-feature loop
    (src/V1/trackFeatures.c:1343-1501) over all lanes at once.

    pyr1/pyr2: (imgs, gxs, gys) from build_pyramids_exact; x, y f32
    [N]; val i32 [N].  Returns (x, y, val)."""
    imgs1, gxs1, gys1 = pyr1
    imgs2, gxs2, gys2 = pyr2
    ss = _F32(float(cfg.subsampling))
    nlev = cfg.n_pyramid_levels
    live = val >= 0

    xloc, yloc = x, y
    for _ in range(nlev):
        xloc = xloc / ss
        yloc = yloc / ss
    xout, yout = xloc, yloc

    status = jnp.full(x.shape, jnp.int32(TRACKED))
    alive = live  # lanes still tracking through the level walk
    for r in range(nlev - 1, -1, -1):
        xloc = xloc * ss
        yloc = yloc * ss
        xout = xout * ss
        yout = yout * ss
        nx, ny, st = _track_level_exact(
            imgs1[r], gxs1[r], gys1[r], imgs2[r], gxs2[r], gys2[r],
            xloc, yloc, xout, yout, alive, cfg)
        xout = jnp.where(alive, nx, xout)
        yout = jnp.where(alive, ny, yout)
        status = jnp.where(alive, st, status)
        # C: KLT_SMALL_DET or KLT_OOB breaks the level loop; other
        # statuses continue to finer levels (and get overwritten)
        alive = alive & ~((st == jnp.int32(SMALL_DET)) |
                          (st == jnp.int32(OOB)))

    # final write-back precedence (src/V1/trackFeatures.c:1382-1437)
    h, w = imgs1[0].shape
    border_oob = ((xout < _F32(cfg.borderx)) |
                  (xout > _F32(w - 1 - cfg.borderx)) |
                  (yout < _F32(cfg.bordery)) |
                  (yout > _F32(h - 1 - cfg.bordery)))
    st = status
    is_oob = (st == jnp.int32(OOB)) | ((st != jnp.int32(SMALL_DET)) &
                                       border_oob)
    killed = is_oob | (st < 0)
    new_val = jnp.where(is_oob, jnp.int32(OOB), st)
    x_out = jnp.where(live, jnp.where(killed, _F32(-1.0), xout), x)
    y_out = jnp.where(live, jnp.where(killed, _F32(-1.0), yout), y)
    v_out = jnp.where(live, jnp.where(killed, new_val,
                                      jnp.int32(TRACKED)), val)
    return x_out, y_out, v_out
