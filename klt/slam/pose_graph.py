"""Pose-graph optimization over SE(3) relative-pose constraints.

The keyframe back-bone of the SLAM extension: given odometry /
loop-closure edges (i, j, relative pose Z_ij, weight), refine absolute
poses by Gauss-Newton on the residual

    r_ij = Log( Z_ij^-1 * (T_i^-1 * T_j) )   in R^6

linearized with jacfwd through the same Taylor-guarded exp map the BA
uses.  The edge axis shards over the mesh's `data` axis exactly like
BA's observations (psum-reduced normal equations inside shard_map) —
small dense solve replicated on every chip.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .geometry import so3_exp, skew
from ..utils.linalg import gj_solve_spd

_HI = jax.lax.Precision.HIGHEST


def so3_log(R):
    """[..., 3, 3] -> [..., 3] axis-angle.

    atan2-based and Taylor-guarded on BOTH branches so jax.jacfwd is
    finite at (and near) the identity — a plain arccos((tr-1)/2) has an
    infinite derivative exactly where pose-graph residuals live (the
    d/dcos arccos blow-up leaks NaN through `where` under jacfwd)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = jnp.stack([R[..., 2, 1] - R[..., 1, 2],
                   R[..., 0, 2] - R[..., 2, 0],
                   R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = jnp.sum(w * w, axis=-1) * 0.25           # sin^2(theta)
    c = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)     # cos(theta)
    # sin(theta) ~ 0 happens BOTH at theta ~ 0 (Taylor branch) and at
    # theta ~ pi, where w ~ 0 but the log is ~ pi * axis: recover the
    # axis there from the symmetric part, aa^T = (S - cI) / (1 - c).
    small = (s2 < 1e-12) & (c > 0.0)
    near_pi = c < -0.999
    s2_safe = jnp.where(small | near_pi, 1.0, s2)
    s_safe = jnp.sqrt(s2_safe)
    theta = jnp.arctan2(s_safe, c)
    scale = jnp.where(small, 0.5 + s2 / 12.0,
                      theta / (2.0 * s_safe))[..., None]
    # near-pi branch: theta from the (guarded) cosine alone — arctan2
    # needs an accurate sine, which w no longer carries there
    theta_pi = jnp.arccos(jnp.maximum(c, -1.0 + 1e-7))
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    one_mc = jnp.where(near_pi, 1.0 - c, 1.0)[..., None]
    axis2 = jnp.maximum((diag - c[..., None]) / one_mc, 1e-12)
    # Relative axis signs from the symmetric part: (S - cI)[i, j] =
    # a_i a_j (1 - c), so sign(a_i) relative to the dominant axis k is
    # sign(S[i, k]) — robust at exactly theta = pi, where componentwise
    # sign(w) would collapse to all-+1 for mixed-sign axes.  The GLOBAL
    # sign comes from w's dominant component (w = 2 sin(theta) a, still
    # accurate slightly below pi); at exactly pi it is the legitimate
    # R(pi, a) == R(pi, -a) ambiguity and +1 is a valid choice.
    S = 0.5 * (R + jnp.swapaxes(R, -1, -2))
    kk = jax.nn.one_hot(jnp.argmax(axis2, axis=-1), 3, dtype=R.dtype)
    scol = jnp.einsum("...ij,...j->...i",
                      S - c[..., None, None] *
                      jnp.eye(3, dtype=R.dtype), kk,
                      precision=jax.lax.Precision.HIGHEST)
    rel = jnp.where(scol >= 0.0, 1.0, -1.0)   # rel[k] = +1 (scol_k > 0)
    wk = jnp.sum(w * kk, axis=-1, keepdims=True)
    sign = jnp.where(wk < 0.0, -rel, rel)
    log_pi = theta_pi[..., None] * sign * jnp.sqrt(axis2)
    return jnp.where(near_pi[..., None], log_pi, w * scale)


@dataclasses.dataclass
class PoseGraph:
    """R: [P,3,3]; t: [P,3]; edges (i, j, Z) with Z = (Rz [E,3,3],
    tz [E,3]) the measured pose of j in i's frame; weight [E]."""

    R: jax.Array
    t: jax.Array
    ei: jax.Array
    ej: jax.Array
    Rz: jax.Array
    tz: jax.Array
    weight: jax.Array

    def pad_edges(self, multiple: int) -> "PoseGraph":
        e = self.ei.shape[0]
        pad = (-e) % multiple
        if pad == 0:
            return self
        z = lambda a, v: jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], v, a.dtype)])
        eye = jnp.broadcast_to(jnp.eye(3, dtype=self.Rz.dtype),
                               (pad, 3, 3))
        return dataclasses.replace(
            self, ei=z(self.ei, 0), ej=z(self.ej, 0),
            Rz=jnp.concatenate([self.Rz, eye]), tz=z(self.tz, 0.0),
            weight=z(self.weight, 0.0))


def _mm(a, b):
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _edge_residual(xi_i, xi_j, Ri, ti, Rj, tj, Rz, tz):
    """r in R^6 for updates T_i <- exp(xi_i) T_i etc."""
    dRi = so3_exp(xi_i[None, :3])[0]
    dRj = so3_exp(xi_j[None, :3])[0]
    Ri_n = _mm(dRi, Ri)
    ti_n = _mm(dRi, ti) + xi_i[3:]
    Rj_n = _mm(dRj, Rj)
    tj_n = _mm(dRj, tj) + xi_j[3:]
    # T_rel = T_i^-1 T_j (camera-from-world convention):
    # R_rel = Ri Rj^T? use world-from-camera? define T = (R, t) with
    # p_cam = R p_world + t; then T_i^-1 T_j has
    R_rel = _mm(Ri_n, Rj_n.T)
    t_rel = ti_n - _mm(R_rel, tj_n)
    # residual vs measurement
    dR = _mm(Rz.T, R_rel)
    rw = so3_log(dR[None])[0]
    rt = _mm(Rz.T, (t_rel - tz))
    return jnp.concatenate([rw, rt])


def _edge_blocks(R, t, ei, ej, Rz, tz, weight):
    z6 = jnp.zeros(6, jnp.float32)

    def one(Ri, ti, Rj, tj, Rzi, tzi):
        r = _edge_residual(z6, z6, Ri, ti, Rj, tj, Rzi, tzi)
        ji = jax.jacfwd(lambda a: _edge_residual(
            a, z6, Ri, ti, Rj, tj, Rzi, tzi))(z6)
        jj = jax.jacfwd(lambda a: _edge_residual(
            z6, a, Ri, ti, Rj, tj, Rzi, tzi))(z6)
        return r, ji, jj

    r, ji, jj = jax.vmap(one)(R[ei], t[ei], R[ej], t[ej], Rz, tz)
    w = weight[:, None, None]
    return r * weight[:, None], ji * w, jj * w


def _gn_step(R, t, pg: PoseGraph, mesh, damping, fix_first):
    n = R.shape[0]

    def local(ei, ej, Rz, tz, weight):
        r, ji, jj = _edge_blocks(R, t, ei, ej, Rz, tz, weight)
        # dense H [P,6,P,6] via joint segment sums (P is small)
        def seg(idx_a, idx_b, ja, jb):
            joint = idx_a * n + idx_b
            blk = jax.ops.segment_sum(
                jnp.einsum("eki,ekj->eij", ja, jb, precision=_HI),
                joint, num_segments=n * n)
            return blk.reshape(n, n, 6, 6)
        H = (seg(ei, ei, ji, ji) + seg(ei, ej, ji, jj) +
             seg(ej, ei, jj, ji) + seg(ej, ej, jj, jj))
        b = (jax.ops.segment_sum(
                -jnp.einsum("eki,ek->ei", ji, r, precision=_HI),
                ei, num_segments=n) +
             jax.ops.segment_sum(
                -jnp.einsum("eki,ek->ei", jj, r, precision=_HI),
                ej, num_segments=n))
        return H, b, jnp.sum(r * r)

    if mesh is not None:
        spec = P("data")
        H, b, cost = shard_map(
            lambda *a: tuple(jax.lax.psum(o, "data") for o in local(*a)),
            mesh=mesh, in_specs=(spec,) * 5, out_specs=P(),
        )(pg.ei, pg.ej, pg.Rz, pg.tz, pg.weight)
    else:
        H, b, cost = local(pg.ei, pg.ej, pg.Rz, pg.tz, pg.weight)

    Hm = H.transpose(0, 2, 1, 3).reshape(n * 6, n * 6)
    lam = jnp.float32(damping)
    Hm = Hm + lam * jnp.diag(jnp.diagonal(Hm)) + 1e-8 * jnp.eye(n * 6)
    rhs = b.reshape(-1)
    if fix_first:
        mask = jnp.ones(n * 6, Hm.dtype).at[:6].set(0.0)
        Hm = Hm * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
        rhs = rhs * mask
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(Hm), 1e-12))
    dx = (jnp.linalg.solve(Hm / d[:, None] / d[None, :], rhs / d) /
          d).reshape(n, 6)

    dR = so3_exp(dx[:, :3])
    R_new = jnp.einsum("pij,pjk->pik", dR, R, precision=_HI)
    t_new = jnp.einsum("pij,pj->pi", dR, t, precision=_HI) + dx[:, 3:]
    return R_new, t_new, cost


def _gn_step_cg(R, t, pg: PoseGraph, mesh, damping, fix_first,
                cg_iters: int, cg_tol: float):
    """Matrix-free edge-list Gauss-Newton step: never materializes the
    [P,6,P,6] H (the dense path's n^2 segment-sum).  Each CG matvec
    streams through the per-edge Jacobians (two gathers + two
    segment-sums), so memory is O(E + P) and the edge axis shards over
    the mesh's `data` axis — the scalable path for pose graphs with
    thousands of keyframes."""
    n = R.shape[0]
    lam = jnp.float32(damping)
    mask = jnp.ones((n, 6), jnp.float32)
    if fix_first:
        mask = mask.at[0].set(0.0)

    def step(ei, ej, Rz, tz, weight, psum):
        r, ji, jj = _edge_blocks(R, t, ei, ej, Rz, tz, weight)
        b = psum(
            jax.ops.segment_sum(
                -jnp.einsum("eki,ek->ei", ji, r, precision=_HI),
                ei, num_segments=n) +
            jax.ops.segment_sum(
                -jnp.einsum("eki,ek->ei", jj, r, precision=_HI),
                ej, num_segments=n))
        cost = psum(jnp.sum(r * r))
        # block-diagonal of H for damping + preconditioning
        Hd = psum(
            jax.ops.segment_sum(
                jnp.einsum("eki,ekj->eij", ji, ji, precision=_HI),
                ei, num_segments=n) +
            jax.ops.segment_sum(
                jnp.einsum("eki,ekj->eij", jj, jj, precision=_HI),
                ej, num_segments=n))
        diag = jnp.einsum("pii->pi", Hd)
        eye6 = jnp.eye(6, dtype=Hd.dtype)[None]
        Hd_damped = Hd + lam * diag[:, :, None] * eye6 + 1e-8 * eye6
        eye6 = jnp.broadcast_to(jnp.eye(6, dtype=Hd_damped.dtype),
                                Hd_damped.shape)
        Minv, _ = gj_solve_spd(Hd_damped, eye6)

        def h_matvec(v):
            v = v * mask
            y = (jnp.einsum("eki,ei->ek", ji, v[ei], precision=_HI) +
                 jnp.einsum("eki,ei->ek", jj, v[ej], precision=_HI))
            out = psum(
                jax.ops.segment_sum(
                    jnp.einsum("eki,ek->ei", ji, y, precision=_HI),
                    ei, num_segments=n) +
                jax.ops.segment_sum(
                    jnp.einsum("eki,ek->ei", jj, y, precision=_HI),
                    ej, num_segments=n))
            out = (out + lam * diag * v + 1e-8 * v) * mask
            return out + v * (1.0 - mask) if fix_first else out

        def precond(v):
            return jnp.einsum("pij,pj->pi", Minv, v, precision=_HI) * mask

        rhs = b * mask
        x0 = jnp.zeros_like(rhs)
        z0 = precond(rhs)
        rz0 = jnp.sum(rhs * z0)
        stop = jnp.float32(cg_tol) ** 2 * jnp.sum(rhs * rhs)

        def cond(state):
            k, _, rr, _, _ = state
            return (k < cg_iters) & (jnp.sum(rr * rr) > stop)

        def body(state):
            k, x, rr, p, rz = state
            hp = h_matvec(p)
            alpha = rz / jnp.maximum(jnp.sum(p * hp), 1e-30)
            x = x + alpha * p
            rr = rr - alpha * hp
            z = precond(rr)
            rz_new = jnp.sum(rr * z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return k + 1, x, rr, p, rz_new

        _, dx, _, _, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), x0, rhs, z0, rz0))
        return dx, cost

    if mesh is not None:
        spec = P("data")
        dx, cost = shard_map(
            lambda *a: step(*a, lambda o: jax.lax.psum(o, "data")),
            mesh=mesh, in_specs=(spec,) * 5, out_specs=P(),
        )(pg.ei, pg.ej, pg.Rz, pg.tz, pg.weight)
    else:
        dx, cost = step(pg.ei, pg.ej, pg.Rz, pg.tz, pg.weight,
                        lambda o: o)

    dR = so3_exp(dx[:, :3])
    R_new = jnp.einsum("pij,pjk->pik", dR, R, precision=_HI)
    t_new = jnp.einsum("pij,pj->pi", dR, t, precision=_HI) + dx[:, 3:]
    return R_new, t_new, cost


def optimize_pose_graph(pg: PoseGraph, mesh: Mesh | None = None,
                        iterations: int = 10, damping: float = 1e-3,
                        fix_first: bool = True, solver: str = "dense",
                        cg_iters: int = 200, cg_tol: float = 1e-6):
    """LM with accept/reject; returns (R, t, costs [iterations]).

    solver="dense" materializes H (fine for tens of keyframes);
    solver="cg" is the matrix-free edge-list path for large graphs.
    """
    if mesh is not None:
        pg = pg.pad_edges(mesh.shape["data"])

    def cost_of(R, t):
        r, _, _ = _edge_blocks(R, t, pg.ei, pg.ej, pg.Rz, pg.tz,
                               pg.weight)
        return jnp.sum(r * r)

    @jax.jit
    def run(R, t):
        c0 = cost_of(R, t)

        def body(carry, _):
            R, t, lam, c_cur = carry
            if solver == "cg":
                Rn, tn, _ = _gn_step_cg(R, t, pg, mesh, lam, fix_first,
                                        cg_iters, cg_tol)
            else:
                Rn, tn, _ = _gn_step(R, t, pg, mesh, lam, fix_first)
            c_new = cost_of(Rn, tn)
            ok = c_new < c_cur
            R = jnp.where(ok, Rn, R)
            t = jnp.where(ok, tn, t)
            lam = jnp.where(ok, jnp.maximum(lam * 0.5, 1e-8), lam * 4.0)
            c_cur = jnp.where(ok, c_new, c_cur)
            return (R, t, lam, c_cur), c_cur

        (Rf, tf, _, _), costs = jax.lax.scan(
            body, (R, t, jnp.float32(damping), c0), None,
            length=iterations)
        return Rf, tf, costs

    return run(pg.R, pg.t)
