"""Batched small-matrix solves without LAPACK custom calls.

jnp.linalg.{det,solve,inv} on batched small matrices lower to LAPACK-
style custom calls.  These helpers stay in pure vector ops, which XLA
fuses with their callers: an unrolled Gauss-Jordan for SPD systems (diagonal
pivots suffice; mirrors the reference's Numerical-Recipes elimination,
src/V1/trackFeatures.c:546-602, including zero-pivot detection) and a
closed-form adjugate inverse for 3x3.
"""

from __future__ import annotations

import jax.numpy as jnp


def gj_solve_spd(T, B):
    """Solve T X = B for batched small SPD T.

    T: [..., n, n]; B: [..., n, m].  Returns (X [..., n, m],
    small [...]) with small=True where a diagonal pivot vanished."""
    n = T.shape[-1]
    A = jnp.concatenate([T, B], axis=-1)
    small = jnp.zeros(T.shape[:-2], bool)
    for col in range(n):
        piv = A[..., col, col]
        small = small | (piv == 0.0)
        piv_safe = jnp.where(piv == 0.0, jnp.float32(1.0), piv)
        arow = A[..., col, :] / piv_safe[..., None]
        A = A - A[..., :, col:col + 1] * arow[..., None, :]
        A = A.at[..., col, :].set(arow)
    return A[..., :, n:], small


def inv3(M, eps: float = 0.0):
    """Closed-form batched 3x3 inverse (adjugate / det).

    M: [..., 3, 3].  Callers are expected to have damped M so det is
    bounded away from zero; `eps` adds a safety floor to |det|."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < eps, jnp.sign(det) * eps + (det == 0) * eps, det)
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    adj = jnp.stack([
        jnp.stack([A, D, G], -1),
        jnp.stack([B, E, H], -1),
        jnp.stack([C, F, I], -1),
    ], -2)
    return adj / det[..., None, None]
