"""Distributed sparse bundle adjustment (Schur complement over a mesh).

The classic BA normal equations have the arrow structure

    [ U   W ] [dx_pose]   [ b_p ]
    [ W^T V ] [dx_lm  ] = [ b_l ]

with U block-diagonal over poses (6x6), V block-diagonal over
landmarks (3x3).  The pose update solves the Schur complement
S = U - W V^-1 W^T; landmarks back-substitute.

Device mapping: the observation axis is the big one, so observations are
sharded over the mesh's `data` axis inside `shard_map`; each shard
reduces its local contributions to (U, V, W, b) with segment-sums, and
one `psum` per tensor yields the replicated reduced system — the
distributed Schur-complement reduction described in SURVEY.md §2.  The
small replicated solve then runs on every chip.

This is the north-star extension beyond the reference (which has no
mapping layer); the front end that feeds it is the tracked
KLT_FeatureTable (slam/chains.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .geometry import se3_exp, se3_apply, project
from ..utils.linalg import gj_solve_spd, inv3

_HI = jax.lax.Precision.HIGHEST


@dataclasses.dataclass
class BAProblem:
    """Dense-indexed bundle adjustment problem.

    R: [P, 3, 3] f32; t: [P, 3] f32 — camera-from-world poses.
    landmarks: [L, 3] f32 world points.
    cam_idx, lm_idx: [M] i32; uv: [M, 2] f32; weight: [M] f32
    (0 disables an observation — used for padding).
    fx, fy, cx, cy: floats.
    """

    R: jax.Array
    t: jax.Array
    landmarks: jax.Array
    cam_idx: jax.Array
    lm_idx: jax.Array
    uv: jax.Array
    weight: jax.Array
    fx: float
    fy: float
    cx: float
    cy: float

    def pad_observations(self, multiple: int) -> "BAProblem":
        m = self.cam_idx.shape[0]
        pad = (-m) % multiple
        if pad == 0:
            return self
        z = lambda a, v: jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], v, a.dtype)])
        return dataclasses.replace(
            self, cam_idx=z(self.cam_idx, 0), lm_idx=z(self.lm_idx, 0),
            uv=z(self.uv, 0.0), weight=z(self.weight, 0.0))


def _residual_one(xi, dlm, R, t, lm, uv, fx, fy, cx, cy):
    """Reprojection residual at local updates (xi, dlm)."""
    dR, dt = se3_exp(xi[None])
    p = se3_apply(R, t, lm + dlm)
    p = se3_apply(dR[0], dt[0], p)
    return project(p, fx, fy, cx, cy) - uv


def _obs_blocks(R, t, landmarks, cam_idx, lm_idx, uv, weight,
                fx, fy, cx, cy):
    """Per-observation residuals + Jacobians, batched with vmap/jacfwd."""
    Ro = R[cam_idx]
    to = t[cam_idx]
    lmo = landmarks[lm_idx]
    zero6 = jnp.zeros(6, jnp.float32)
    zero3 = jnp.zeros(3, jnp.float32)

    def one(Ri, ti, lmi, uvi):
        r = _residual_one(zero6, zero3, Ri, ti, lmi, uvi, fx, fy, cx, cy)
        jp = jax.jacfwd(lambda xi: _residual_one(
            xi, zero3, Ri, ti, lmi, uvi, fx, fy, cx, cy))(zero6)
        jl = jax.jacfwd(lambda dl: _residual_one(
            zero6, dl, Ri, ti, lmi, uvi, fx, fy, cx, cy))(zero3)
        return r, jp, jl

    r, jp, jl = jax.vmap(one)(Ro, to, lmo, uv)  # [M,2], [M,2,6], [M,2,3]
    w = weight[:, None, None]
    return r * weight[:, None], jp * w, jl * w


def _reduce_blocks(r, jp, jl, cam_idx, lm_idx, n_pose, n_lm):
    """Segment-reduced normal-equation blocks from local observations."""
    U = jax.ops.segment_sum(jnp.einsum("mki,mkj->mij", jp, jp, precision=_HI),
                            cam_idx, num_segments=n_pose)
    V = jax.ops.segment_sum(jnp.einsum("mki,mkj->mij", jl, jl, precision=_HI),
                            lm_idx, num_segments=n_lm)
    bp = jax.ops.segment_sum(-jnp.einsum("mki,mk->mi", jp, r, precision=_HI),
                             cam_idx, num_segments=n_pose)
    bl = jax.ops.segment_sum(-jnp.einsum("mki,mk->mi", jl, r, precision=_HI),
                             lm_idx, num_segments=n_lm)
    # W as [L, P*6, 3] via joint segment id (dense [P,L,6,3] done small)
    joint = lm_idx * n_pose + cam_idx
    Wj = jax.ops.segment_sum(jnp.einsum("mki,mkj->mij", jp, jl, precision=_HI),
                             joint, num_segments=n_pose * n_lm)
    W = Wj.reshape(n_lm, n_pose, 6, 3).transpose(1, 0, 2, 3)
    return U, V, W, bp, bl


def _gn_step(R, t, landmarks, prob: BAProblem, mesh: Mesh | None,
             damping: float, fix_first: bool):
    n_pose = R.shape[0]
    n_lm = landmarks.shape[0]
    consts = (prob.fx, prob.fy, prob.cx, prob.cy)

    def local(cam_idx, lm_idx, uv, weight):
        r, jp, jl = _obs_blocks(R, t, landmarks, cam_idx, lm_idx, uv,
                                weight, *consts)
        U, V, W, bp, bl = _reduce_blocks(r, jp, jl, cam_idx, lm_idx,
                                         n_pose, n_lm)
        cost = jnp.sum(r * r)
        return U, V, W, bp, bl, cost

    if mesh is not None:
        def sharded(cam_idx, lm_idx, uv, weight):
            out = local(cam_idx, lm_idx, uv, weight)
            return tuple(jax.lax.psum(o, "data") for o in out)

        spec = P("data")
        U, V, W, bp, bl, cost = shard_map(
            sharded, mesh=mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=P(),
        )(prob.cam_idx, prob.lm_idx, prob.uv, prob.weight)
    else:
        U, V, W, bp, bl, cost = local(prob.cam_idx, prob.lm_idx,
                                      prob.uv, prob.weight)

    # Marquardt scaling: damp proportionally to each block's diagonal
    # (handles the mixed rad/px/unit scales), plus a small absolute
    # floor for unobserved parameters.
    lam = jnp.float32(damping)
    eye6 = jnp.eye(6, dtype=U.dtype)[None]
    eye3 = jnp.eye(3, dtype=V.dtype)[None]
    du = jnp.einsum("pii->pi", U)[:, :, None] * eye6
    dv = jnp.einsum("lii->li", V)[:, :, None] * eye3
    U = U + lam * du + 1e-6 * eye6
    V = V + lam * dv + 1e-6 * eye3

    Vinv = inv3(V)                                 # [L, 3, 3]
    WVinv = jnp.einsum("plij,ljk->plik", W, Vinv, precision=_HI)  # [P, L, 6, 3]
    S = -jnp.einsum("plik,qlmk->piqm", WVinv, W, precision=_HI)   # -W V^-1 W^T
    idx = jnp.arange(n_pose)
    S = S.at[idx, :, idx, :].add(U)
    S = S.reshape(n_pose * 6, n_pose * 6)

    rhs = bp - jnp.einsum("plik,lk->pi", WVinv, bl, precision=_HI)

    if fix_first:
        # gauge fix: clamp pose 0 by zeroing its rows/cols + identity
        mask = jnp.ones(n_pose * 6, S.dtype).at[:6].set(0.0)
        S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
        rhs = rhs * mask.reshape(n_pose, 6)

    # Jacobi preconditioning: the raw Schur system spans ~8 orders of
    # magnitude in f32 (fx^2-scaled rotation blocks vs unit translation
    # blocks); scaling by sqrt(diag) keeps the f32 solve accurate.
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(S), 1e-12))
    Sp = S / d[:, None] / d[None, :]
    rhsp = rhs.reshape(-1) / d
    dx_pose = (jnp.linalg.solve(Sp, rhsp) / d).reshape(n_pose, 6)
    dx_lm = jnp.einsum("lij,lj->li", Vinv,
                       bl - jnp.einsum("plik,pi->lk", W, dx_pose,
                                       precision=_HI), precision=_HI)

    dR, dt = se3_exp(dx_pose)
    R_new = jnp.einsum("pij,pjk->pik", dR, R, precision=_HI)
    t_new = jnp.einsum("pij,pj->pi", dR, t, precision=_HI) + dt
    lm_new = landmarks + dx_lm
    return R_new, t_new, lm_new, cost


def _gn_step_cg(R, t, landmarks, prob: BAProblem, mesh: Mesh | None,
                damping: float, fix_first: bool, cg_iters: int,
                cg_tol: float):
    """Matrix-free Schur Gauss-Newton step for large problems.

    Never materializes W (the [P, L, 6, 3] pose-landmark coupling) or
    the dense Schur matrix: S·x products stream through the
    per-observation Jacobians with two segment-sums, so memory is
    O(M + P + L) and the observation axis shards over the mesh's
    `data` axis (one psum per matvec).  The pose system solves with
    preconditioned CG (block-Jacobi on the damped U blocks); landmarks
    back-substitute per landmark.  This is the "keyframes and map
    blocks partitioned across a pod slice" path of the north star —
    the dense _gn_step above stays for small refinements.
    """
    n_pose = R.shape[0]
    n_lm = landmarks.shape[0]
    consts = (prob.fx, prob.fy, prob.cx, prob.cy)
    lam = jnp.float32(damping)

    def local_blocks(cam_idx, lm_idx, uv, weight):
        r, jp, jl = _obs_blocks(R, t, landmarks, cam_idx, lm_idx, uv,
                                weight, *consts)
        U = jax.ops.segment_sum(
            jnp.einsum("mki,mkj->mij", jp, jp, precision=_HI),
            cam_idx, num_segments=n_pose)
        V = jax.ops.segment_sum(
            jnp.einsum("mki,mkj->mij", jl, jl, precision=_HI),
            lm_idx, num_segments=n_lm)
        bp = jax.ops.segment_sum(
            -jnp.einsum("mki,mk->mi", jp, r, precision=_HI),
            cam_idx, num_segments=n_pose)
        bl = jax.ops.segment_sum(
            -jnp.einsum("mki,mk->mi", jl, r, precision=_HI),
            lm_idx, num_segments=n_lm)
        cost = jnp.sum(r * r)
        return U, V, bp, bl, cost, jp, jl

    def damp(U, V):
        eye6 = jnp.eye(6, dtype=U.dtype)[None]
        eye3 = jnp.eye(3, dtype=V.dtype)[None]
        du = jnp.einsum("pii->pi", U)[:, :, None] * eye6
        dv = jnp.einsum("lii->li", V)[:, :, None] * eye3
        return U + lam * du + 1e-6 * eye6, V + lam * dv + 1e-6 * eye3

    mask = jnp.ones((n_pose, 6), jnp.float32)
    if fix_first:
        mask = mask.at[0].set(0.0)

    def make_solve(U, Vinv, bp, bl, matvec_wvw):
        """CG on the gauge-masked Schur system."""
        rhs = bp - matvec_wvw(bl, from_lm=True)
        rhs = rhs * mask

        eye6 = jnp.broadcast_to(jnp.eye(6, dtype=U.dtype),
                                U.shape)
        Uinv, _ = gj_solve_spd(U, eye6)  # block-Jacobi preconditioner

        def precond(v):
            return jnp.einsum("pij,pj->pi", Uinv, v,
                              precision=_HI) * mask

        def s_matvec(v):
            v = v * mask
            uv_ = jnp.einsum("pij,pj->pi", U, v, precision=_HI)
            out = (uv_ - matvec_wvw(v, from_lm=False)) * mask
            # identity on the gauge-fixed block keeps S definite
            return out + v * (1.0 - mask) if fix_first else out

        x0 = jnp.zeros_like(rhs)
        r0 = rhs
        z0 = precond(r0)
        p0 = z0
        rz0 = jnp.sum(r0 * z0)
        stop = jnp.float32(cg_tol) ** 2 * jnp.sum(rhs * rhs)

        def cond(state):
            k, _, r, _, _ = state
            return (k < cg_iters) & (jnp.sum(r * r) > stop)

        def body(state):
            k, x, r, p, rz = state
            sp = s_matvec(p)
            alpha = rz / jnp.maximum(jnp.sum(p * sp), 1e-30)
            x = x + alpha * p
            r = r - alpha * sp
            z = precond(r)
            rz_new = jnp.sum(r * z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return k + 1, x, r, p, rz_new

        _, dx_pose, _, _, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), x0, r0, p0, rz0))
        return dx_pose, rhs

    def step(cam_idx, lm_idx, uv, weight, psum):
        U, V, bp, bl, cost, jp, jl = local_blocks(cam_idx, lm_idx, uv,
                                                  weight)
        U, V, bp, bl, cost = psum((U, V, bp, bl, cost))
        U, V = damp(U, V)
        Vinv = inv3(V)

        def matvec_wvw(v, from_lm):
            """from_lm=False: (W V^-1 W^T) v for v [P, 6];
            from_lm=True:  (W V^-1) v      for v [L, 3]."""
            if from_lm:
                w = jnp.einsum("lij,lj->li", Vinv, v, precision=_HI)
            else:
                y = jnp.einsum("mki,mi->mk", jp, v[cam_idx],
                               precision=_HI)            # [Mloc, 2]
                z = jax.ops.segment_sum(
                    jnp.einsum("mki,mk->mi", jl, y, precision=_HI),
                    lm_idx, num_segments=n_lm)           # W^T v (local)
                z = psum(z)
                w = jnp.einsum("lij,lj->li", Vinv, z, precision=_HI)
            out = jax.ops.segment_sum(
                jnp.einsum("mki,mkj,mj->mi", jp, jl, w[lm_idx],
                           precision=_HI),
                cam_idx, num_segments=n_pose)            # W w (local)
            return psum(out)

        dx_pose, _ = make_solve(U, Vinv, bp, bl, matvec_wvw)

        # landmark back-substitution: dl = V^-1 (bl - W^T dx)
        y = jnp.einsum("mki,mi->mk", jp, dx_pose[cam_idx],
                       precision=_HI)
        wt_dx = psum(jax.ops.segment_sum(
            jnp.einsum("mki,mk->mi", jl, y, precision=_HI),
            lm_idx, num_segments=n_lm))
        dx_lm = jnp.einsum("lij,lj->li", Vinv, bl - wt_dx,
                           precision=_HI)
        return dx_pose, dx_lm, cost

    if mesh is not None:
        def sharded(cam_idx, lm_idx, uv, weight):
            return step(cam_idx, lm_idx, uv, weight,
                        lambda o: jax.lax.psum(o, "data"))

        spec = P("data")
        dx_pose, dx_lm, cost = shard_map(
            sharded, mesh=mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=P(),
        )(prob.cam_idx, prob.lm_idx, prob.uv, prob.weight)
    else:
        dx_pose, dx_lm, cost = step(prob.cam_idx, prob.lm_idx, prob.uv,
                                    prob.weight, lambda o: o)

    dR, dt = se3_exp(dx_pose)
    R_new = jnp.einsum("pij,pjk->pik", dR, R, precision=_HI)
    t_new = jnp.einsum("pij,pj->pi", dR, t, precision=_HI) + dt
    return R_new, t_new, landmarks + dx_lm, cost


def _total_cost(R, t, landmarks, prob: BAProblem):
    r, _, _ = _obs_blocks(R, t, landmarks, prob.cam_idx, prob.lm_idx,
                          prob.uv, prob.weight,
                          prob.fx, prob.fy, prob.cx, prob.cy)
    return jnp.sum(r * r)


def _residual_norms(R, t, landmarks, prob: BAProblem):
    """Per-observation UNWEIGHTED residual norms [M] (for IRLS)."""
    ones = jnp.ones_like(prob.weight)
    r, _, _ = _obs_blocks(R, t, landmarks, prob.cam_idx, prob.lm_idx,
                          prob.uv, ones,
                          prob.fx, prob.fy, prob.cx, prob.cy)
    return jnp.sqrt(jnp.sum(r * r, axis=-1))


def bundle_adjust(prob: BAProblem, mesh: Mesh | None = None,
                  iterations: int = 10, damping: float = 10.0,
                  fix_first: bool = True,
                  robust_delta: float | None = None):
    """Levenberg-Marquardt with adaptive damping.

    Each iteration computes one damped Schur step; the step is accepted
    only if it lowers the total cost (otherwise the damping is raised
    and the step retried on the next iteration — classic LM, expressed
    as a fixed-trip scan with masked accept for XLA).

    robust_delta (px): Huber IRLS — observations with residual norm n
    beyond delta are down-weighted by delta/n each iteration, so
    front-end outliers (drifted tracks that survived the residue test)
    stop dominating the quadratic cost.  None = plain least squares.

    Returns (R, t, landmarks, costs [iterations]) — costs are the
    accepted (weighted) cost after each iteration.
    """
    if mesh is not None:
        prob = prob.pad_observations(mesh.shape["data"])
    return _lm_drive(prob, mesh, iterations, damping,
                     lambda R, t, lm, lam, pw: _gn_step(
                         R, t, lm, pw, mesh, lam, fix_first),
                     robust_delta)


def bundle_adjust_cg(prob: BAProblem, mesh: Mesh | None = None,
                     iterations: int = 10, damping: float = 10.0,
                     fix_first: bool = True, cg_iters: int = 250,
                     cg_tol: float = 1e-5,
                     robust_delta: float | None = None):
    """Levenberg-Marquardt with the matrix-free Schur/CG inner solver
    (_gn_step_cg) — the scalable path for hundreds of keyframes and
    tens of thousands of landmarks, observation-sharded over the mesh.

    Same accept/reject semantics as `bundle_adjust` (incl. the Huber
    IRLS option); prefer this whenever n_pose * n_lm is too large to
    materialize W densely.
    """
    if mesh is not None:
        prob = prob.pad_observations(mesh.shape["data"])
    return _lm_drive(prob, mesh, iterations, damping,
                     lambda R, t, lm, lam, pw: _gn_step_cg(
                         R, t, lm, pw, mesh, lam, fix_first,
                         cg_iters, cg_tol),
                     robust_delta)


def _refit_landmarks(R, t, lm, prob: BAProblem, iters: int = 3,
                     robust_delta: float = 2.0):
    """Robust landmark-only refinement with poses FIXED: per-landmark
    damped GN on its own observations, fully parallel over landmarks.

    This rescues landmarks the gating loop would otherwise freeze
    dead: a landmark whose support fell below the gate keeps a stale
    3D position, so its clean observations never pass the gate again.
    With poses near-correct, a Huber refit pulls each landmark to the
    consistent majority of its observations."""
    n_lm = int(prob.landmarks.shape[0])
    d = jnp.float32(robust_delta)

    def body(lm, _):
        n = _residual_norms(R, t, lm, prob)
        hub = jnp.where(n <= d, 1.0, jnp.sqrt(d / jnp.maximum(n, d)))
        r, _, jl = _obs_blocks(R, t, lm, prob.cam_idx, prob.lm_idx,
                               prob.uv, prob.weight * hub,
                               prob.fx, prob.fy, prob.cx, prob.cy)
        V = jax.ops.segment_sum(
            jnp.einsum("mki,mkj->mij", jl, jl, precision=_HI),
            prob.lm_idx, num_segments=n_lm)
        bl = jax.ops.segment_sum(
            -jnp.einsum("mki,mk->mi", jl, r, precision=_HI),
            prob.lm_idx, num_segments=n_lm)
        V = V + 1e-4 * jnp.eye(3, dtype=jnp.float32)
        dlm = jnp.einsum("lij,lj->li", inv3(V), bl)
        return lm + dlm, None

    lm, _ = jax.lax.scan(body, lm, None, length=iters)
    return lm


def bundle_adjust_gated(prob: BAProblem, mesh: Mesh | None = None,
                        rounds: int = 3, iterations: int = 20,
                        damping: float = 10.0, fix_first: bool = True,
                        cg_iters: int = 250, cg_tol: float = 1e-5,
                        robust_delta: float = 2.0,
                        gate_px: float = 2.0,
                        min_obs_per_lm: int = 2):
    """Geometrically gated BA: alternate robust LM rounds with
    reprojection-threshold track pruning — the classic SLAM inlier
    gating loop (VERDICT r4 item 6: the Huber IRLS alone was carrying
    a 61%-outlier association load from drifted front-end tracks).

    After each round the active set is RE-EVALUATED from the current
    solution: observations whose UNWEIGHTED residual norm exceeds
    `gate_px` sit out the next round (weight 0), and landmarks left
    with fewer than `min_obs_per_lm` live observations are dropped
    entirely.  Re-evaluation (rather than monotone shrinking) matters
    under heavy contamination: the first round's solution is still
    pulled by outliers, so clean observations can transiently exceed
    the gate and must be able to re-enter once the solve recovers —
    a genuinely drifted track stays out because the solution moves
    away from it, not toward it.

    Returns (R, t, landmarks, costs [rounds*iterations], active [M]
    bool — the observations the final solution is supported by)."""
    R, t, lm = prob.R, prob.t, prob.landmarks
    active = np.asarray(prob.weight) > 0
    fed = np.asarray(prob.weight) > 0  # caller's hard zero-weights
    n_lm = int(prob.landmarks.shape[0])
    base_w = prob.weight
    costs_all = []
    for rd in range(rounds):
        pw = dataclasses.replace(
            prob, R=R, t=t, landmarks=lm,
            weight=jnp.where(jnp.asarray(active), base_w, 0.0))
        R, t, lm, costs = bundle_adjust_cg(
            pw, mesh, iterations, damping, fix_first, cg_iters,
            cg_tol, robust_delta)
        costs_all.append(np.asarray(costs))
        if rd < rounds - 1:
            # rescue frozen landmarks before re-evaluating the gate
            lm = _refit_landmarks(R, t, lm, prob, 3, robust_delta)
            rn = np.asarray(_residual_norms(R, t, lm, prob))
            # annealed gate: wide early (the round-1 solution is still
            # outlier-pulled; a tight early gate over-prunes clean
            # observations), tightening to gate_px for the final round
            gate = gate_px * (2.0 ** (rounds - 2 - rd))
            act = fed & (rn <= gate)
            cnt = np.zeros(n_lm, np.int32)
            np.add.at(cnt, np.asarray(prob.lm_idx), act.astype(np.int32))
            act &= cnt[np.asarray(prob.lm_idx)] >= min_obs_per_lm
            if act.sum() < 6:  # never gate into a degenerate problem
                break
            active = act
    return R, t, lm, jnp.asarray(np.concatenate(costs_all)), active


def _lm_drive(prob: BAProblem, mesh: Mesh | None, iterations: int,
              damping: float, gn_step, robust_delta=None):
    # prob must already be padded to the mesh (callers do it before
    # binding gn_step, which receives the reweighted problem per step)

    @jax.jit
    def run(R, t, lm):
        def weighted(R, t, lm):
            if robust_delta is None:
                return prob
            # Huber IRLS: the multiplicative factor enters r and J, so
            # sqrt(delta/n) yields the Huber weight in the normals
            n = _residual_norms(R, t, lm, prob)
            d = jnp.float32(robust_delta)
            w = jnp.where(n <= d, 1.0, jnp.sqrt(d / jnp.maximum(n, d)))
            return dataclasses.replace(prob, weight=prob.weight * w)

        def body(carry, _):
            R, t, lm, lam = carry
            pw = weighted(R, t, lm)
            c_cur = _total_cost(R, t, lm, pw)
            out = gn_step(R, t, lm, lam, pw)
            Rn, tn, lmn = out[0], out[1], out[2]
            c_new = _total_cost(Rn, tn, lmn, pw)
            ok = c_new < c_cur
            sel = lambda a, b: jnp.where(ok, a, b)
            R = jnp.where(ok, Rn, R)
            t = sel(tn, t)
            lm = sel(lmn, lm)
            lam = jnp.where(ok, jnp.maximum(lam * 0.5, 1e-6), lam * 4.0)
            return (R, t, lm, lam), sel(c_new, c_cur)

        (Rf, tf, lmf, _), costs = jax.lax.scan(
            body, (R, t, lm, jnp.float32(damping)), None,
            length=iterations)
        return Rf, tf, lmf, costs

    return run(prob.R, prob.t, prob.landmarks)
