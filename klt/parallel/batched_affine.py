"""Batched multi-sequence affine-checked tracking.

Runs B sequences concurrently: translation through the batched level
driver (parallel/batched_lk.py), the affine consistency stage through
ops/affine.py's batched-image path (lane axis flattened seq-major over
[B, H, W] frames, so every einsum/solve in the Gauss-Newton loop is one
[B*N]-lane op and the compaction/repair cond predicates stay GLOBAL
scalars; a plain jax.vmap would select both branches of every cond per
sequence, paying the full-width fallbacks every step).  Same per-lane
arithmetic and parity contract per sequence as the single-stream path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import TrackingConfig
from ..ops.affine import _affine_step_jit, _PATCH_BORDER
from ..ops.pyramid import build_pyramid_stacks_batched
from ..utils.knobs import precomp_pyramids, scan_unroll, trace_key
from .batched_lk import track_features_pyramid_batched


def track_sequences_affine_batched(frames, x, y, val,
                                   cfg: TrackingConfig):
    """Track B sequences with the affine consistency check inside one
    compiled scan.

    frames: uint8 [B, T, H, W]; x, y f32 [B, N]; val i32 [B, N].
    Returns (xs, ys, vals) of shape [T-1, B, N]."""
    return _track_sequences_affine_batched(frames, x, y, val, cfg,
                                           trace_key(), precomp_pyramids())


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _track_sequences_affine_batched(frames, x, y, val,
                                    cfg: TrackingConfig,
                                    trace_key=None,
                                    precomp: bool = False):
    b, t_all = frames.shape[0], frames.shape[1]
    n = x.shape[1]
    nf = b * n

    pw = cfg.affine_window_width + _PATCH_BORDER
    ph = cfg.affine_window_height + _PATCH_BORDER
    z = jnp.zeros((nf, ph, pw), jnp.float32)
    v0 = jnp.zeros(nf, jnp.float32)
    aff0 = (jnp.zeros(nf, bool), z, z, z, v0, v0,
            jnp.ones(nf, jnp.float32), v0, v0, jnp.ones(nf, jnp.float32))

    st0 = build_pyramid_stacks_batched(frames[:, 0], cfg)
    if precomp:
        # every step's stacks built ahead of the scan by the per-step
        # program (see utils.knobs.precomp_pyramids)
        xs = jax.lax.map(lambda f: build_pyramid_stacks_batched(f, cfg),
                         frames[:, 1:].swapaxes(0, 1))
    else:
        xs = jnp.arange(1, t_all)

    def body(carry, xs_t):
        st1, xc, yc, vc, aff = carry
        st2 = (xs_t if precomp
               else build_pyramid_stacks_batched(frames[:, xs_t], cfg))
        xn, yn, vn = track_features_pyramid_batched(st1, st2, xc, yc, vc,
                                                    cfg)
        a1, a2 = st1[0], st2[0]
        out = _affine_step_jit(
            *aff, a1[:, 0], a1[:, 1], a1[:, 2], a2[:, 0], a2[:, 1], a2[:, 2],
            xc.reshape(-1), yc.reshape(-1), xn.reshape(-1),
            yn.reshape(-1), vn.reshape(-1), cfg, trace_key)
        aff_new = tuple(out[:10])
        xo = out[10].reshape(b, n)
        yo = out[11].reshape(b, n)
        vo = out[12].reshape(b, n)
        return (st2, xo, yo, vo, aff_new), (xo, yo, vo)

    _, tables = jax.lax.scan(body, (st0, x, y, val, aff0), xs,
                             unroll=scan_unroll())
    return tables
