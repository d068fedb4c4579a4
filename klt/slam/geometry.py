"""Batched SE(3) and pinhole-camera primitives (pure jnp, f32).

Everything is written for dense batches: poses [P, 6] (axis-angle +
translation twists), landmarks [L, 3], observations indexed by dense
int arrays, in place of per-camera pointer
structures.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def skew(w):
    """[..., 3] -> [..., 3, 3] cross-product matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], -1),
        jnp.stack([wz, z, -wx], -1),
        jnp.stack([-wy, wx, z], -1),
    ], -2)


def so3_exp(w):
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation.

    Taylor-guarded so jax.jacfwd at w = 0 is exact (a plain
    norm-and-divide NaNs under differentiation at zero)."""
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    small = theta2 < 1e-8
    t2s = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(t2s)
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / t2s)
    K = skew(w)  # unnormalized
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    KK = jnp.matmul(K, K, precision=jax.lax.Precision.HIGHEST)
    return eye + A * K + B * KK


def se3_exp(xi):
    """[..., 6] twist (omega, t) -> (R [..., 3, 3], t [..., 3]).

    Uses the first-order translation (common in GN refinement where the
    retraction only needs to be a chart around identity).
    """
    return so3_exp(xi[..., :3]), xi[..., 3:]


def se3_apply(R, t, p):
    """Apply [..., 3, 3] + [..., 3] to points [..., 3]."""
    return jnp.einsum("...ij,...j->...i", R, p,
                      precision=jax.lax.Precision.HIGHEST) + t


def project(p_cam, fx, fy, cx, cy):
    """Pinhole projection of camera-frame points [..., 3] -> [..., 2]."""
    z = jnp.maximum(p_cam[..., 2], _EPS)
    u = fx * p_cam[..., 0] / z + cx
    v = fy * p_cam[..., 1] / z + cy
    return jnp.stack([u, v], -1)


def reproject(pose_xi, base_R, base_t, landmark, fx, fy, cx, cy):
    """Residual helper: world landmark -> pixel under pose = exp(xi)∘base.

    pose_xi [..., 6] local update; base_R/base_t the current pose
    estimate; landmark [..., 3].
    """
    dR, dt = se3_exp(pose_xi)
    p = se3_apply(base_R, base_t, landmark)
    p = se3_apply(dR, dt, p)
    return project(p, fx, fy, cx, cy)
