"""Batched multi-sequence LK tracking.

B sequences advance together: level stacks travel as [B, 3, H_l, W_l]
and feature state as [B, F].  On an NVIDIA GPU each level is ONE launch
of the LK kernel (pallas/lk.py) over all B*F lanes, each lane carrying
its sequence index into the [B, 3, H, W] stack; elsewhere the
single-sequence level path is vmapped.  This is the throughput path for
tracking many videos per card (and, sharded over a mesh's `data` axis,
per host).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import TrackingConfig, TRACKED, OOB
from ..ops.lk import coarse_to_fine, track_level
from ..ops.pyramid import build_pyramid_stacks_batched
from ..pallas import lk_kernel_enabled
from ..pallas.lk import track_level_lanes
from ..utils.knobs import precomp_pyramids, scan_unroll, trace_key


def track_level_batched(st1, st2, x1, y1, x2, y2, active,
                        cfg: TrackingConfig):
    """ops.lk.track_level over B sequences: st1/st2 [B, 3, H, W], lane
    arrays [B, F].  Same per-lane results as B single-sequence calls."""
    b, _, nr, nc = st1.shape
    if nr < cfg.window_height + 1 or nc < cfg.window_width + 1:
        status = jnp.where(active, jnp.int32(OOB), jnp.int32(TRACKED))
        return x2, y2, status, jnp.zeros_like(status)
    if lk_kernel_enabled():
        f = x1.shape[1]
        seq = jnp.repeat(jnp.arange(b, dtype=jnp.int32), f)
        flat = lambda v: v.reshape(b * f)
        outs = track_level_lanes(st1, st2, flat(x1), flat(y1), flat(x2),
                                 flat(y2), flat(active), seq, cfg=cfg)
        return tuple(o.reshape(b, f) for o in outs)
    return jax.vmap(lambda *a: track_level(*a, cfg))(
        st1, st2, x1, y1, x2, y2, active)


def track_features_pyramid_batched(sts1, sts2, x, y, val,
                                   cfg: TrackingConfig):
    """Batched coarse-to-fine driver: sts1/sts2 are finest-first lists
    of [B, 3, H_l, W_l] level stacks; x, y f32 [B, F]; val i32 [B, F].
    Mirrors ops.lk.track_features_pyramid's classification exactly."""
    nr0, nc0 = sts1[0].shape[-2], sts1[0].shape[-1]
    return coarse_to_fine(track_level_batched, sts1, sts2, x, y, val, cfg,
                          nr0, nc0)


def make_fused_pair_step(cfg: TrackingConfig):
    """Batched frame-pair step with one LK launch per level.

    step(img1 [B,H,W] u8, img2, x [B,N], y, val) -> (x, y, val).
    """

    def step(img1, img2, x, y, val):
        return track_features_pyramid_batched(
            build_pyramid_stacks_batched(img1, cfg),
            build_pyramid_stacks_batched(img2, cfg), x, y, val, cfg)

    return step


def track_sequences_batched(frames, x, y, val, cfg: TrackingConfig):
    """Track B sequences through T frames with device-resident pyramid
    carry and one LK launch per level per step.

    frames: uint8 [B, T, H, W]; x, y f32 [B, N]; val i32 [B, N].
    Returns (xs, ys, vals) of shape [T-1, B, N].
    """
    return _track_sequences_batched(frames, x, y, val, cfg, trace_key(),
                                    precomp_pyramids())


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _track_sequences_batched(frames, x, y, val, cfg: TrackingConfig,
                             trace_key=None, precomp: bool = False):
    b, t_all = frames.shape[0], frames.shape[1]
    st0 = build_pyramid_stacks_batched(frames[:, 0], cfg)
    if precomp:
        # every step's stacks built ahead of the scan by the per-step
        # program (see utils.knobs.precomp_pyramids)
        xs = jax.lax.map(lambda f: build_pyramid_stacks_batched(f, cfg),
                         frames[:, 1:].swapaxes(0, 1))
    else:
        xs = jnp.arange(1, t_all)

    def body(carry, xs_t):
        st1, xc, yc, vc = carry
        st2 = (xs_t if precomp
               else build_pyramid_stacks_batched(frames[:, xs_t], cfg))
        xn, yn, vn = track_features_pyramid_batched(st1, st2, xc, yc, vc,
                                                    cfg)
        return (st2, xn, yn, vn), (xn, yn, vn)

    _, tables = jax.lax.scan(body, (st0, x, y, val), xs,
                             unroll=scan_unroll())
    return tables
