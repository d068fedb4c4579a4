"""Device-resident streaming sequence tracker.

Compiles the whole frame loop into one XLA program: a `lax.scan` over the
frame axis carrying the previous frame's pyramids on device (sequential
mode without any host round-trip — the end state of the optimization arc
the reference walked from V2's per-call copies to V3's device-resident
pyramids, src/V3/trackFeaturesGPU.cu:481-484).  Frames are uploaded once
as a uint8 [T, H, W] tensor; per-frame feature tables come back stacked.
"""

from __future__ import annotations

import os
import functools

import jax
import jax.numpy as jnp

from ..config import TrackingConfig
from ..ops.pyramid import build_image_pyramids, build_pyramid_stacks
from ..ops.lk import track_features_pyramid, track_features_pyramid_stacks
from ..utils.knobs import precomp_pyramids, scan_unroll, trace_key


def _stacks_stream(frames_tail, cfg: TrackingConfig):
    """Pyramid stacks for T frames, built ahead of the tracking scan by
    the same per-frame program: tuple of [T, 3, H_l, W_l] per level."""
    return jax.lax.map(lambda f: tuple(build_pyramid_stacks(f, cfg)),
                       frames_tail)


def track_sequence(frames, x, y, val, cfg: TrackingConfig):
    """Track features through a whole sequence in one compiled program.

    frames: uint8/f32 [T, H, W]; x, y f32 [N]; val i32 [N].
    Returns (xs, ys, vals) of shape [T-1, N]: the state after tracking
    into each frame t (t = 1..T-1).  Pyramid levels travel as stacked
    [3, H_l, W_l] arrays, so the scan body performs no re-stacking.
    """
    return _track_sequence_jit(frames, x, y, val, cfg,
                               precomp_pyramids(), trace_key())


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _track_sequence_jit(frames, x, y, val, cfg: TrackingConfig,
                        precomp: bool, trace_key=None):
    st0 = tuple(build_pyramid_stacks(frames[0], cfg))

    def body(carry, xs):
        st1, x, y, val = carry
        st2 = xs if precomp else tuple(build_pyramid_stacks(xs, cfg))
        xn, yn, vn = track_features_pyramid_stacks(
            list(st1), list(st2), x, y, val, cfg)
        return (st2, xn, yn, vn), (xn, yn, vn)

    xs = _stacks_stream(frames[1:], cfg) if precomp else frames[1:]
    (_, xf, yf, vf), tables = jax.lax.scan(
        body, (st0, x, y, val), xs, unroll=scan_unroll())
    return tables


def track_pair_carry(pyr1_state, img2, feat, cfg: TrackingConfig):
    """One frame-pair step with explicit device-resident pyramid carry
    (stacked-level state, as produced by prepare_pyramids).

    Returns ((x, y, val), pyr2_state).  Donatable building block for
    host-driven streaming (e.g. with lost-feature replacement between
    frames, which needs the host's greedy suppression).
    """
    return _track_pair_carry_jit(pyr1_state, img2, feat, cfg,
                                 trace_key())


@functools.partial(jax.jit, static_argnums=(3, 4))
def _track_pair_carry_jit(pyr1_state, img2, feat, cfg: TrackingConfig,
                          trace_key=None):
    x, y, val = feat
    st2 = tuple(build_pyramid_stacks(img2, cfg))
    xn, yn, vn = track_features_pyramid_stacks(
        list(pyr1_state), list(st2), x, y, val, cfg)
    return (xn, yn, vn), st2


def prepare_pyramids(img, cfg: TrackingConfig):
    """Jitted pyramid builder (stacked levels) for the first frame of a
    stream."""
    return _prepare_jit(img, cfg, trace_key())


@functools.partial(jax.jit, static_argnums=(1, 2))
def _prepare_jit(img, cfg: TrackingConfig, trace_key=None):
    return tuple(build_pyramid_stacks(img, cfg))


def track_sequence_replace(frames, x, y, val, cfg: TrackingConfig):
    """Whole-sequence tracking with per-frame lost-feature replacement
    running INSIDE the compiled scan (ops.replace — device-resident
    greedy suppression, no host round-trips).

    The device analogue of the reference's example3 REPLACE loop
    (src/V3/example3GPU.c:34-88: KLTTrackFeatures then
    KLTReplaceLostFeatures every frame).  frames: uint8/f32 [T, H, W];
    x, y f32 [N]; val i32 [N].  Returns (xs, ys, vals) of shape
    [T-1, N] — the state after tracking into frame t and replacing.
    """
    return _track_sequence_replace_jit(frames, x, y, val, cfg,
                                       precomp_pyramids(),
                                       trace_key())


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _track_sequence_replace_jit(frames, x, y, val, cfg: TrackingConfig,
                                precomp: bool, trace_key=None):
    from ..ops.replace import replace_lost_features_device

    st0 = tuple(build_pyramid_stacks(frames[0], cfg))

    def body(carry, xs):
        st1, x, y, val = carry
        st2 = xs if precomp else tuple(build_pyramid_stacks(xs, cfg))
        xn, yn, vn = track_features_pyramid_stacks(
            list(st1), list(st2), x, y, val, cfg)
        xn, yn, vn = replace_lost_features_device(
            st2[0][1], st2[0][2], xn, yn, vn, cfg)
        return (st2, xn, yn, vn), (xn, yn, vn)

    xs = _stacks_stream(frames[1:], cfg) if precomp else frames[1:]
    (_, xf, yf, vf), tables = jax.lax.scan(
        body, (st0, x, y, val), xs, unroll=scan_unroll())
    return tables


@functools.partial(jax.jit, static_argnums=(5, 6), donate_argnums=(0,))
def _replace_chunk_flagged_jit(pyr1_state, frames, x, y, val,
                               cfg: TrackingConfig, trace_key=None):
    """Scan one frame chunk with reference-exact in-scan replacement
    (ops/replace_exact), outputting per-frame post-replace AND
    pre-replace states plus the per-frame tie flags the repair driver
    needs.  Returns ((x, y, val), pyr_final, per-frame ys)."""
    from ..ops.replace_exact import replace_lost_features_exact


    def body(carry, frame):
        st1, x, y, v = carry
        st2 = tuple(build_pyramid_stacks(frame, cfg))
        xn, yn, vn = track_features_pyramid_stacks(
            list(st1), list(st2), x, y, v, cfg)
        xr, yr, vr, tie = replace_lost_features_exact(frame, xn, yn, vn,
                                                      cfg)
        return (st2, xr, yr, vr), (xr, yr, vr, xn, yn, vn, tie)

    (st_f, xf, yf, vf), ys = jax.lax.scan(
        body, (pyr1_state, x, y, val), frames,
        unroll=scan_unroll())
    return (xf, yf, vf), st_f, ys


@functools.partial(jax.jit, static_argnums=(5,), donate_argnums=(0,))
def _replace_chunk_exact_jit(pyr1, frames, x, y, val,
                             cfg: TrackingConfig):
    """Scan one frame chunk on the BIT-EXACT tier: tracking via
    ops/lk_exact (every f32 op rounds as the reference C loop does, so
    positions and kill decisions are bit-identical — one ulp of drift
    flips min-distance stamp geometry and cascades the picks) and
    replacement via the exact integer response, reusing the tracking
    pyramid's level-0 gradients (the reference's sequential-mode reuse,
    src/V1/selectGoodFeatures.c:342-348)."""
    from ..ops.lk_exact import build_pyramids_exact, track_features_exact
    from ..ops.replace_exact import replace_lost_features_exact

    def body(carry, frame):
        p1, x, y, v = carry
        p2 = build_pyramids_exact(frame, cfg)
        xn, yn, vn = track_features_exact(p1, p2, x, y, v, cfg)
        xr, yr, vr, tie = replace_lost_features_exact(
            frame, xn, yn, vn, cfg, grads=(p2[1][0], p2[2][0]))
        return (p2, xr, yr, vr), (xr, yr, vr, xn, yn, vn, tie)

    (pf, xf, yf, vf), ys = jax.lax.scan(body, (pyr1, x, y, val),
                                        frames, unroll=scan_unroll())
    return (xf, yf, vf), pf, ys


@functools.partial(jax.jit, static_argnums=(1,))
def _exact_pyramids_jit(frame, cfg: TrackingConfig):
    from ..ops.lk_exact import build_pyramids_exact
    return build_pyramids_exact(frame, cfg)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _exact_response_jit(frame, cfg: TrackingConfig, trace_key=None):
    from ..ops.replace_exact import exact_response_device
    return exact_response_device(frame, cfg)


def _repair_replacement_host(frame, pre_x, pre_y, pre_val,
                             cfg: TrackingConfig):
    """Reference-exact replacement for ONE tie-flagged frame: the
    device's bit-exact response + the host native quicksort walk
    (klt/native) resolves the integer tie with the reference's
    own sort scheme (src/V1/selectGoodFeatures.c:62-96,171-239)."""
    import numpy as np
    from .. import native
    from ..ops.selection import candidate_points

    resp = np.asarray(_exact_response_jit(frame, cfg, trace_key()))
    h, w = resp.shape
    fx = np.ascontiguousarray(pre_x, np.float32)
    fy = np.ascontiguousarray(pre_y, np.float32)
    fv = np.ascontiguousarray(pre_val, np.int32)
    pts = candidate_points(resp, cfg, w, h)
    native.sort_points_desc(pts)
    native.min_dist_suppress(pts, fx, fy, fv, w, h, cfg.mindist,
                             cfg.min_eigenvalue, False)
    return fx, fy, fv


def track_sequence_replace_exact(frames, x, y, val, cfg: TrackingConfig):
    """Whole-sequence tracking with REFERENCE-EXACT semantics: by
    default BOTH the tracking (ops/lk_exact — bit-identical positions
    and kill decisions) and the per-frame replacement run on the
    bit-exact tier, so the produced table matches the reference CPU
    tracker's bit-for-bit except at integer response TIES in a pick
    decision (the one case quicksort order decides); the scan flags
    those frames and they are repaired on the host with the native
    quicksort walk, then the scan resumes from the repaired state.
    Tie-free spans (measured ~90% of frames on images_traffic) never
    leave the device.

    KLT_REPLACE_TRACK_TIER=fast keeps the fast LK tier for
    tracking (≈ulp-accurate, not bit-exact — stamp-geometry flips can
    cascade picks; kept for A/B measurement).

    frames: uint8/f32 [T, H, W] (host or device); x, y f32 [N]; val
    i32 [N].  Returns numpy (xs, ys, vals) of shape [T-1, N] matching
    track_sequence_replace's contract, with picks equal to the
    reference CPU tracker's (KLTReplaceLostFeatures each frame).
    """
    import numpy as np

    exact_tier = os.environ.get("KLT_REPLACE_TRACK_TIER",
                                "exact") != "fast"
    t_total = int(frames.shape[0])
    n = int(x.shape[0])
    chunk = max(1, int(os.environ.get("KLT_REPLACE_CHUNK", "32")))
    out_x = np.empty((t_total - 1, n), np.float32)
    out_y = np.empty((t_total - 1, n), np.float32)
    out_v = np.empty((t_total - 1, n), np.int32)

    def build_state(frame):
        return (_exact_pyramids_jit(frame, cfg) if exact_tier
                else prepare_pyramids(frame, cfg))

    def run_chunk(pyr, fb, xd, yd, vd):
        if exact_tier:
            return _replace_chunk_exact_jit(pyr, fb, xd, yd, vd, cfg)
        return _replace_chunk_flagged_jit(pyr, fb, xd, yd, vd, cfg,
                                          trace_key())

    pyr = build_state(jnp.asarray(frames[0]))
    xd, yd, vd = jnp.asarray(x), jnp.asarray(y), jnp.asarray(val)

    t = 1  # next frame index to track into
    while t < t_total:
        rem = t_total - t
        # power-of-two dispatch lengths bound compile count at
        # log2(chunk)+1 programs (same scheme as track_sequence_stream)
        step = chunk if rem >= chunk else 1 << (rem.bit_length() - 1)
        fb = jnp.asarray(frames[t:t + step])
        (xf, yf, vf), pyr2, ys = run_chunk(pyr, fb, xd, yd, vd)
        ties = np.asarray(ys[6])
        if not ties.any():
            out_x[t - 1:t - 1 + step] = np.asarray(ys[0])
            out_y[t - 1:t - 1 + step] = np.asarray(ys[1])
            out_v[t - 1:t - 1 + step] = np.asarray(ys[2])
            pyr = pyr2
            xd, yd, vd = xf, yf, vf
            t += step
            continue
        k = int(np.argmax(ties))  # first tie-flagged offset
        if k:
            out_x[t - 1:t - 1 + k] = np.asarray(ys[0][:k])
            out_y[t - 1:t - 1 + k] = np.asarray(ys[1][:k])
            out_v[t - 1:t - 1 + k] = np.asarray(ys[2][:k])
        fxr, fyr, fvr = _repair_replacement_host(
            jnp.asarray(frames[t + k]), np.asarray(ys[3][k]),
            np.asarray(ys[4][k]), np.asarray(ys[5][k]), cfg)
        out_x[t - 1 + k] = fxr
        out_y[t - 1 + k] = fyr
        out_v[t - 1 + k] = fvr
        xd = jnp.asarray(fxr)
        yd = jnp.asarray(fyr)
        vd = jnp.asarray(fvr)
        pyr = build_state(jnp.asarray(frames[t + k]))
        t += k + 1
    return out_x, out_y, out_v


def track_sequence_affine(frames, x, y, val, cfg: TrackingConfig):
    """Whole-sequence tracking with the affine consistency check
    running inside the compiled scan.

    Carries the per-feature affine state (reference aff_* fields,
    src/V1/klt.h:96-105) through the scan: reference patches saved at
    each feature's first successful track, then re-verified against the
    current frame every step; drifting features are killed
    (src/V1/trackFeatures.c:1438-1497).

    frames: uint8/f32 [T, H, W]; x, y f32 [N]; val i32 [N].
    Returns (xs, ys, vals) of shape [T-1, N].
    """
    return _track_sequence_affine_jit(frames, x, y, val, cfg,
                                      precomp_pyramids(),
                                      trace_key())


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _track_sequence_affine_jit(frames, x, y, val, cfg: TrackingConfig,
                               precomp: bool, trace_key=None):
    from ..ops.affine import AffineState, _affine_step_jit, _PATCH_BORDER
    import jax.numpy as jnp

    n = x.shape[0]
    pw = cfg.affine_window_width + _PATCH_BORDER
    ph = cfg.affine_window_height + _PATCH_BORDER
    z = jnp.zeros((n, ph, pw), jnp.float32)
    v0 = jnp.zeros(n, jnp.float32)
    aff0 = (jnp.zeros(n, bool), z, z, z, v0, v0,
            jnp.ones(n, jnp.float32), v0, v0, jnp.ones(n, jnp.float32))

    pyr0 = tuple(build_pyramid_stacks(frames[0], cfg))

    def body(carry, xs):
        st1, xc, yc, vc, aff = carry
        st2 = xs if precomp else tuple(build_pyramid_stacks(xs, cfg))
        xn, yn, vn = track_features_pyramid_stacks(
            list(st1), list(st2), xc, yc, vc, cfg)
        out = _affine_step_jit(
            *aff, st1[0][0], st1[0][1], st1[0][2],
            st2[0][0], st2[0][1], st2[0][2],
            xc, yc, xn, yn, vn, cfg, trace_key)
        aff_new = tuple(out[:10])
        x_out, y_out, val_out = out[10], out[11], out[12]
        return ((st2, x_out, y_out, val_out, aff_new),
                (x_out, y_out, val_out))

    xs = _stacks_stream(frames[1:], cfg) if precomp else frames[1:]
    (_, xf, yf, vf, _), tables = jax.lax.scan(
        body, (pyr0, x, y, val, aff0), xs, unroll=scan_unroll())
    return tables


def track_sequence_stream(frames_iter, x, y, val, cfg: TrackingConfig,
                          chunk: int = 64):
    """Track an arbitrarily long sequence in O(chunk) device memory.

    Streams frames through chunked `track_sequence_carry` dispatches,
    carrying the previous chunk's last pyramid on device — the unbounded
    version of the reference's sequential mode
    (src/V1/trackFeatures.c:1285-1294: O(1) frames in memory).

    frames_iter: iterable of uint8 [H, W] frames (the first frame
    included); x, y f32 [N]; val i32 [N] host arrays.
    Yields (frame_index, x, y, val) numpy snapshots after each chunk.
    """
    import numpy as np

    it = iter(frames_iter)
    first = next(it)
    pyr = prepare_pyramids(jnp.asarray(first), cfg)
    xd, yd, vd = jnp.asarray(x), jnp.asarray(y), jnp.asarray(val)

    t = 0
    done = False
    while not done:
        block = []
        for _ in range(chunk):
            try:
                block.append(next(it))
            except StopIteration:
                done = True
                break
        if not block:
            break
        # full chunks share one compiled program; a partial tail is
        # dispatched as power-of-two sub-chunks so the process compiles
        # at most log2(chunk) tail programs total instead of one per
        # distinct sequence length
        frames_np = np.stack(block)
        off = 0
        rem = len(block)
        while rem:
            step = chunk if rem >= chunk else 1 << (rem.bit_length() - 1)
            fb = jnp.asarray(frames_np[off:off + step])
            (xd, yd, vd), pyr = _track_chunk_carry(pyr, fb, xd, yd, vd,
                                                   cfg)
            off += step
            rem -= step
        t += len(block)
        yield t, np.asarray(xd), np.asarray(yd), np.asarray(vd)


def _track_chunk_carry(pyr1_state, frames, x, y, val,
                       cfg: TrackingConfig):
    return _track_chunk_carry_jit(pyr1_state, frames, x, y, val, cfg,
                                  precomp_pyramids(), trace_key())


@functools.partial(jax.jit, static_argnums=(5, 6, 7),
                   donate_argnums=(0,))
def _track_chunk_carry_jit(pyr1_state, frames, x, y, val,
                           cfg: TrackingConfig, precomp: bool,
                           trace_key=None):
    """Scan one frame chunk, carrying pyramids in (donated) device
    buffers across dispatches."""

    def body(carry, xs):
        st1, x, y, v = carry
        st2 = xs if precomp else tuple(build_pyramid_stacks(xs, cfg))
        xn, yn, vn = track_features_pyramid_stacks(
            list(st1), list(st2), x, y, v, cfg)
        return (st2, xn, yn, vn), None

    xs = _stacks_stream(frames, cfg) if precomp else frames
    (st2, xf, yf, vf), _ = jax.lax.scan(
        body, (pyr1_state, x, y, val), xs)
    return (xf, yf, vf), st2
