"""Device-resident lost-feature replacement.

The device-resident equivalent of KLTReplaceLostFeatures
(src/V1/selectGoodFeatures.c:514-541): recompute the min-eigenvalue
response from the current frame's finest-level gradients (the reference
reuses the cached pyramid gradients in sequential mode,
src/V1/selectGoodFeatures.c:342-348), then greedily accept the best
candidate outside every live feature's suppression square, one per lost
slot — entirely on device, so per-frame replacement can run INSIDE the
compiled tracking scan with zero host round-trips.

Equivalence to the reference: the reference sorts all candidates
descending and walks them, skipping stamped ones — identical to
repeatedly taking the masked argmax.  At exact value ties (truncated
ints) the device argmax picks the first candidate in row-major scan
order, while the reference picks whichever its full-array quicksort
permutation put first — both are valid greedy outcomes; everywhere else
the result is identical.  The host path (runtime.tracker.KLTracker +
klt.native) remains the bit-exact-parity tier.

Suppression geometry: a Chebyshev square of radius mindist-1
(reference: the `mindist--` before _fillFeaturemap,
src/V1/selectGoodFeatures.c:158-168).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TrackingConfig, NOT_FOUND
from .selection import corner_response, _candidate_borders


def _masked_response_int(gx, gy, cfg: TrackingConfig):
    """Truncated-int response with border / step / floor masking.
    Invalid pixels carry -1 (all valid candidates are >= floor >= 1)."""
    h, w = gx.shape
    floor = max(1, int(cfg.min_eigenvalue))
    resp = corner_response(gx, gy, cfg.window_width, cfg.window_height)
    ri = resp.astype(jnp.int32)  # C (int) cast: trunc toward zero
    borderx, bordery, step = _candidate_borders(cfg)
    yi = jnp.arange(h, dtype=jnp.int32)[:, None]
    xi = jnp.arange(w, dtype=jnp.int32)[None, :]
    valid = ((yi >= bordery) & (yi < h - bordery) &
             (xi >= borderx) & (xi < w - borderx))
    if step > 1:
        valid &= (((yi - bordery) % step) == 0) & \
                 (((xi - borderx) % step) == 0)
    return jnp.where(valid & (ri >= floor), ri, jnp.int32(-1))


def _stamp_live_features(masked, x, y, val, cfg: TrackingConfig):
    """Kill every candidate within the suppression square of a live
    feature.  The feature point-mask is built with a one-hot matmul
    and dilated by two separable max-pools."""
    h, w = masked.shape
    stamp = max(int(cfg.mindist) - 1, 0)
    live = (val >= 0).astype(jnp.float32)
    fy = y.astype(jnp.int32)
    fx = x.astype(jnp.int32)
    rows = ((jnp.arange(h, dtype=jnp.int32)[None, :] == fy[:, None])
            .astype(jnp.float32) * live[:, None])        # [F, H]
    cols = (jnp.arange(w, dtype=jnp.int32)[None, :] ==
            fx[:, None]).astype(jnp.float32)             # [F, W]
    pm = jnp.einsum("fh,fw->hw", rows, cols,
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
    k = 2 * stamp + 1
    dil = jax.lax.reduce_window(pm, -jnp.inf, jax.lax.max,
                                (k, k), (1, 1), "SAME")
    return jnp.where(dil > 0.5, jnp.int32(-1), masked)


def replace_lost_features_device(gx, gy, x, y, val, cfg: TrackingConfig):
    """Fill lost slots (val < 0) with fresh features, on device.

    gx, gy: [H, W] finest-level gradient maps of the CURRENT frame;
    x, y f32 [N]; val i32 [N].  Returns (x, y, val) with each lost slot
    either refilled (val = truncated response, like the reference's
    stored candidate value) or marked NOT_FOUND with x = y = -1 when no
    candidate of at least max(1, min_eigenvalue) survives suppression
    (src/V1/selectGoodFeatures.c:180-195).
    """
    h, w = gx.shape
    floor = max(1, int(cfg.min_eigenvalue))
    stamp = max(int(cfg.mindist) - 1, 0)
    m = _masked_response_int(gx, gy, cfg)
    m = _stamp_live_features(m, x, y, val, cfg)

    yi = jnp.arange(h, dtype=jnp.int32)[:, None]
    xi = jnp.arange(w, dtype=jnp.int32)[None, :]

    def cond(state):
        m, x, y, val = state
        return jnp.any(val < 0) & (jnp.max(m) >= floor)

    def body(state):
        m, x, y, val = state
        idx = jnp.argmax(m.reshape(-1))  # ties: first in scan order
        py = (idx // w).astype(jnp.int32)
        px = (idx - py * w).astype(jnp.int32)
        v = m.reshape(-1)[idx]
        slot = jnp.argmax(val < 0)  # first lost slot, like the
        #                             reference's indx walk
        x = x.at[slot].set(px.astype(jnp.float32))
        y = y.at[slot].set(py.astype(jnp.float32))
        val = val.at[slot].set(v)
        killed = (jnp.abs(yi - py) <= stamp) & (jnp.abs(xi - px) <= stamp)
        m = jnp.where(killed, jnp.int32(-1), m)
        return m, x, y, val

    m, x, y, val = jax.lax.while_loop(cond, body, (m, x, y, val))
    # exhausted: remaining lost slots become NOT_FOUND at (-1, -1)
    lost = val < 0
    x = jnp.where(lost, jnp.float32(-1.0), x)
    y = jnp.where(lost, jnp.float32(-1.0), y)
    val = jnp.where(lost, jnp.int32(NOT_FOUND), val)
    return x, y, val
