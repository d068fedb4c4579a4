"""Reference-faithful device-resident lost-feature replacement.

The reference's replacement picks are deterministic given (a) the
integer-cast min-eigenvalue response (src/V1/selectGoodFeatures.c:421)
and (b) its quicksort tie order (:62-96).  The plain device tier
(ops/replace.py) computes the response in XLA's reduction order, so
ulp-level differences flip integer casts and the picks cascade away
from the reference (r4: 51% slot-frame agreement on images_traffic).

This module closes that gap ON DEVICE:

* `exact_response_device` recomputes the selection response with the C
  code's exact f32 accumulation ORDER — separable convolutions as
  sequential shift-FMA chains (tap k = width-1..0, pixel offset
  -radius..+radius, src/V1/convolve.c:137-242), window sums as
  row-major per-cell chains (src/V1/selectGoodFeatures.c:398-406), and
  _minEigenvalue's mixed precision (f32 sums/products, f64 sqrt and
  final combine, :289-292) emulated in double-f32 (Dekker two_prod +
  one Newton correction of the f32 sqrt), written for devices without
  f64.  Residual f32-ulp differences from the sqrt emulation must never
  cross an integer boundary of the (int)-cast response.

* `replace_lost_features_exact` fills lost slots by iterated masked
  argmax over the int response.  This is PROVABLY the reference's
  sorted greedy walk (src/V1/selectGoodFeatures.c:116-239): the walk's
  next acceptance is always the maximum-valued unstamped candidate
  (stamps only accumulate, so previously skipped candidates stay
  dead), so when that maximum is UNIQUE the outcomes are identical —
  picks, slot assignment and stamp evolution.  The only divergence
  window is an exact integer TIE at a pick decision, where the
  reference's full-array quicksort permutation chooses; the loop
  detects every such tie and returns a per-call `tie` flag so callers
  can route flagged frames to the host's bit-exact native walk
  (klt/native) — tie-free calls (measured ~90% on images_traffic)
  are reference-exact entirely on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TrackingConfig, NOT_FOUND
from ..kernels import gaussian_kernels
from .selection import _candidate_borders
from .replace import _stamp_live_features

_F32 = jnp.float32
_INT_LIMIT = np.float32(2147483583.0)  # largest f32 below 2^31-1


def _conv_h_exact(img, taps):
    """Horizontal pass in the C accumulation order
    (src/V1/convolve.c:137-182): term m = pixel[i - radius + m] *
    taps[width-1-m], summed sequentially in f32; borders zeroed.
    The explicit add chain is a data dependence XLA cannot reassociate,
    so the per-pixel f32 rounding sequence equals the C loop's."""
    width = int(taps.shape[0])
    r = width // 2
    h, w = img.shape
    if w < width:
        return jnp.zeros_like(img)
    acc = img[:, 0:w - 2 * r] * _F32(float(taps[width - 1]))
    for m in range(1, width):
        acc = acc + img[:, m:w - 2 * r + m] * _F32(float(taps[width - 1 - m]))
    return jnp.pad(acc, ((0, 0), (r, r)))


def _conv_v_exact(img, taps):
    """Vertical pass, C order (src/V1/convolve.c:189-242)."""
    width = int(taps.shape[0])
    r = width // 2
    h, w = img.shape
    if h < width:
        return jnp.zeros_like(img)
    acc = img[0:h - 2 * r, :] * _F32(float(taps[width - 1]))
    for m in range(1, width):
        acc = acc + img[m:h - 2 * r + m, :] * _F32(float(taps[width - 1 - m]))
    return jnp.pad(acc, ((r, r), (0, 0)))


def _two_prod(a, b):
    """Dekker two-product: a*b = p + e exactly in f32 (no FMA)."""
    p = a * b
    c = _F32(4097.0)  # 2^12 + 1 Veltkamp splitter for f32
    a1 = a * c
    ah = a1 - (a1 - a)
    al = a - ah
    b1 = b * c
    bh = b1 - (b1 - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _min_eig_f64_emulated(gxx, gxy, gyy):
    """f32(((f64)(gxx+gyy) - sqrt((f64)disc)) / 2) without f64: one
    Newton correction of the f32 sqrt in double-f32 arithmetic.  The C
    expression (src/V1/selectGoodFeatures.c:289-292) computes disc and
    tr in f32, promotes to f64 only for sqrt and the final combine."""
    t1 = gxx - gyy
    disc = t1 * t1 + (_F32(4.0) * gxy) * gxy
    tr = gxx + gyy
    s0 = jnp.sqrt(disc)
    # s = s0 + (disc - s0^2) / (2 s0), residual kept in double-f32
    p, e = _two_prod(s0, s0)
    r_hi, r_lo = _two_sum(disc, -p)
    r = r_hi + (r_lo - e)
    s1 = r / (_F32(2.0) * s0)
    a, b = _two_sum(tr, -s0)
    lam = (a + (b - s1)) * _F32(0.5)
    return jnp.where(disc > 0, lam, (tr - s0) * _F32(0.5))


def exact_response_device(frame, cfg: TrackingConfig):
    """Selection response from a raw [H, W] frame with the reference's
    exact f32 operation order (the full REPLACING_SOME preprocessing
    chain: smooth with smooth_sigma, gradients with grad_sigma — the
    sequential-mode pyramid-level-0 chain of
    src/V1/selectGoodFeatures.c:342-364).  Returns f32 [H, W], valid in
    the window interior, -3e38 sentinel outside."""
    fi = frame.astype(_F32)
    if cfg.smooth_before_selecting:
        g_s, _ = gaussian_kernels(cfg.smooth_sigma)
        fi = _conv_v_exact(_conv_h_exact(fi, g_s), g_s)
    g, d = gaussian_kernels(cfg.grad_sigma)
    gx = _conv_v_exact(_conv_h_exact(fi, d), g)
    gy = _conv_v_exact(_conv_h_exact(fi, g), d)
    return exact_response_from_grads(gx, gy, cfg)


def exact_response_from_grads(gx, gy, cfg: TrackingConfig):
    """Exact-order response from already-built level-0 gradients — the
    sequential-mode reuse of tc->pyramid_last's gradients
    (src/V1/selectGoodFeatures.c:342-348).  The gradients must come
    from the C-ordered conv chain (ops/lk_exact.build_pyramids_exact
    builds the identical maps, so in-scan callers avoid recomputing
    the smoothing + gradient convolutions)."""
    hh, hw = cfg.window_height // 2, cfg.window_width // 2
    h, w = gx.shape
    vh, vw = h - 2 * hh, w - 2 * hw
    gxx = jnp.zeros((vh, vw), _F32)
    gxy = jnp.zeros((vh, vw), _F32)
    gyy = jnp.zeros((vh, vw), _F32)
    # row-major per-cell accumulation (src/V1/selectGoodFeatures.c:398-406)
    for dy in range(cfg.window_height):
        for dx in range(cfg.window_width):
            a = jax.lax.slice(gx, (dy, dx), (dy + vh, dx + vw))
            b = jax.lax.slice(gy, (dy, dx), (dy + vh, dx + vw))
            gxx = gxx + a * a
            gxy = gxy + a * b
            gyy = gyy + b * b
    lam = _min_eig_f64_emulated(gxx, gxy, gyy)
    lam = jnp.minimum(lam, _INT_LIMIT)  # int-capacity clamp (:415-420)
    return jnp.pad(lam, ((hh, hh), (hw, hw)), constant_values=_F32(-3e38))


def _masked_int_response(resp, cfg: TrackingConfig):
    """Truncated-int response with border / step / floor masking;
    invalid pixels carry -1 (valid candidates are >= floor >= 1)."""
    h, w = resp.shape
    floor = max(1, int(cfg.min_eigenvalue))
    ri = jnp.where(resp > 0, resp, _F32(0.0)).astype(jnp.int32)
    borderx, bordery, step = _candidate_borders(cfg)
    yi = jnp.arange(h, dtype=jnp.int32)[:, None]
    xi = jnp.arange(w, dtype=jnp.int32)[None, :]
    valid = ((yi >= bordery) & (yi < h - bordery) &
             (xi >= borderx) & (xi < w - borderx))
    if step > 1:
        valid &= (((yi - bordery) % step) == 0) & \
                 (((xi - borderx) % step) == 0)
    return jnp.where(valid & (ri >= floor), ri, jnp.int32(-1))


def replace_lost_features_exact(frame, x, y, val, cfg: TrackingConfig,
                                grads=None):
    """Fill lost slots (val < 0) on device with the reference's exact
    pick semantics; returns (x, y, val, tie) where tie=True flags a
    call whose outcome depended on an integer response tie (the one
    case the device cannot resolve reference-faithfully — route those
    frames to the host native walk).

    frame: [H, W] raw frame (uint8/f32); x, y f32 [N]; val i32 [N];
    grads: optional precomputed exact level-0 (gx, gy) — the
    sequential-mode gradient reuse."""
    h, w = frame.shape
    floor = max(1, int(cfg.min_eigenvalue))
    stamp = max(int(cfg.mindist) - 1, 0)

    n_lost = jnp.sum(val < 0)

    def do_replace(_):
        resp = (exact_response_from_grads(*grads, cfg) if grads
                else exact_response_device(frame, cfg))
        m = _masked_int_response(resp, cfg)
        m = _stamp_live_features(m, x, y, val, cfg)

        yi = jnp.arange(h, dtype=jnp.int32)[:, None]
        xi = jnp.arange(w, dtype=jnp.int32)[None, :]

        def cond(state):
            m, x, y, val, tie = state
            return jnp.any(val < 0) & (jnp.max(m) >= floor)

        def body(state):
            m, x, y, val, tie = state
            flat = m.reshape(-1)
            mx = jnp.max(flat)
            idx = jnp.argmax(flat)  # row-major-first on ties
            tie = tie | (jnp.sum(flat == mx) > 1)
            py = (idx // w).astype(jnp.int32)
            px = (idx - py * w).astype(jnp.int32)
            slot = jnp.argmax(val < 0)  # first lost slot (indx walk)
            x = x.at[slot].set(px.astype(jnp.float32))
            y = y.at[slot].set(py.astype(jnp.float32))
            val = val.at[slot].set(mx)
            killed = ((jnp.abs(yi - py) <= stamp) &
                      (jnp.abs(xi - px) <= stamp))
            m = jnp.where(killed, jnp.int32(-1), m)
            return m, x, y, val, tie

        m1, x1, y1, v1, tie = jax.lax.while_loop(
            cond, body, (m, x, y, val, jnp.bool_(False)))
        lost = v1 < 0
        x1 = jnp.where(lost, jnp.float32(-1.0), x1)
        y1 = jnp.where(lost, jnp.float32(-1.0), y1)
        v1 = jnp.where(lost, jnp.int32(NOT_FOUND), v1)
        return x1, y1, v1, tie

    def no_replace(_):
        return x, y, val, jnp.bool_(False)

    return jax.lax.cond(n_lost > 0, do_replace, no_replace, None)
