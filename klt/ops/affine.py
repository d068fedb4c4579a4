"""Affine / similarity / translation consistency checking.

Batched re-design of the reference's per-feature drift detector
(_am_trackFeatureAffine and helpers, src/V1/trackFeatures.c:506-1220;
driver integration :1438-1497): after each successful translation track,
a feature is compared against a reference patch saved at its first
successful track.  Drifting features are killed.

Batched mapping:
* per-feature reference patches (the C code's aff_img* FloatImages,
  src/V1/klt.h:96-105) are dense [N, ph, pw] tensors with a validity mask
  instead of NULL pointers;
* the 6x6 / 4x4 normal equations are built as one batched einsum
  (T = D^T D with D the [N, K, P] design matrix — algebraically identical
  to the unrolled accumulations in src/V1/trackFeatures.c:730-797 and
  :846-893) and solved with a batched linear solve in place of the
  per-feature Gauss-Jordan elimination (:546-602);
* the Newton loop is a fixed-trip fori_loop with per-feature masks.

Behavioural parity notes:
* mode 0 = translation-only check, 1 = similarity (4 DoF),
  2 = full affine (6 DoF), matching affineConsistencyCheck;
* the error vector is scaled by 0.5 (:836, :928), the translation branch
  by step_factor (:1047);
* the drift kill compares SIGNED displacement against
  affine_max_displacement_differ (:1191 — no fabs in the reference;
  replicated);
* on success the feature KEEPS the translation tracker's position — the
  reference discards the affine tracker's x2 (:1493-1494).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TrackingConfig, TRACKED, SMALL_DET, OOB, LARGE_RESIDUE
from .interp import (bilinear_sample, window_offsets,
                     pack_stack_channels, extract_packed_cb)

import os

_EPS = np.float32(1.001)
_PATCH_BORDER = 2  # interpolation margin around the affine window (:1439)
_RESIDENT = int(os.environ.get("KLT_AFFINE_RESIDENT_P", "32"))
# per-feature resident image patch side (gather-free warped sampling).
# Sampling-einsum + extraction cost scales with P; margin excursions
# are not kills (they route to the escape-repair pass), so the default
# is the smallest patch that keeps the window's warp margin.
_HI = jax.lax.Precision.HIGHEST
# Warped-window sampling is a weighted one-hot selection of f32 image
# data; below HIGHEST the GPU rounds the image operand (TF32 keeps 10
# mantissa bits), so every sampling einsum asks for HIGHEST.


def _bilinear_weights(u, v, ph, pw):
    """One-hot bilinear weight vectors for patch-frame coordinates:
    (wy [N, K, Ph], wx [N, K, Pw])."""
    u = jnp.clip(u, 0.0, np.float32(pw - 2))
    v = jnp.clip(v, 0.0, np.float32(ph - 2))
    ui = u.astype(jnp.int32)
    vi = v.astype(jnp.int32)
    fu = (u - ui.astype(jnp.float32))[..., None]
    fv = (v - vi.astype(jnp.float32))[..., None]
    iy = jnp.arange(ph, dtype=jnp.int32)
    ix = jnp.arange(pw, dtype=jnp.int32)
    wy = ((vi[..., None] == iy) * (1.0 - fv) +
          ((vi[..., None] + 1) == iy) * fv)
    wx = ((ui[..., None] == ix) * (1.0 - fu) +
          ((ui[..., None] + 1) == ix) * fu)
    return wy, wx


def _sample_in_patch(patch, u, v):
    """Bilinear samples at arbitrary (possibly warped) patch-frame
    coordinates, gather-free.

    patch [N, Ph, Pw]; u, v [N, K].  The bilinear weights become
    per-row/per-column one-hot vectors and the sample is two
    HIGHEST-precision einsums (the reference's _interpolate,
    src/V1/trackFeatures.c:31-57, one scalar at a time)."""
    n, ph, pw = patch.shape
    wy, wx = _bilinear_weights(u, v, ph, pw)
    tmp = jnp.einsum("nki,nij->nkj", wy, patch, precision=_HI,
                     preferred_element_type=jnp.float32)
    return jnp.einsum("nkj,nkj->nk", tmp, wx, precision=_HI,
                      preferred_element_type=jnp.float32)


def _solve_sym_small(T, e):
    """Batched small symmetric-PSD solve (utils.linalg.gj_solve_spd):
    the reference's Numerical-Recipes elimination contract
    (src/V1/trackFeatures.c:546-602) without batched-LAPACK custom
    calls.  Returns (a [N, n], small [N])."""
    from ..utils.linalg import gj_solve_spd
    X, small = gj_solve_spd(T, e[..., None])
    return X[..., 0], small


def _sample_in_patch3(packed, u, v, pres):
    """Same, but for a channel-block packed patch [N, P, 3P]: ONE
    shared weight build + one row einsum for all three channels.
    Returns (img, gx, gy) samples, each [N, K]."""
    wy, wx = _bilinear_weights(u, v, pres, pres)
    tmp = jnp.einsum("nki,nij->nkj", wy, packed, precision=_HI,
                     preferred_element_type=jnp.float32)  # [N, K, 3P]
    outs = []
    for c in range(3):
        outs.append(jnp.einsum(
            "nkj,nkj->nk", tmp[:, :, c * pres:(c + 1) * pres], wx,
            precision=_HI, preferred_element_type=jnp.float32))
    return outs


@dataclasses.dataclass
class AffineState:
    """Per-feature reference patches + affine parameters (device arrays)."""

    valid: jax.Array      # bool[N] — patch saved (C: aff_img != NULL)
    img: jax.Array        # f32[N, ph, pw]
    gradx: jax.Array
    grady: jax.Array
    x: jax.Array          # f32[N] patch-frame center (C aff_x)
    y: jax.Array
    axx: jax.Array        # f32[N] affine map (C aff_Axx..aff_Ayy)
    ayx: jax.Array
    axy: jax.Array
    ayy: jax.Array

    @classmethod
    def create(cls, n: int, cfg: TrackingConfig) -> "AffineState":
        pw = cfg.affine_window_width + _PATCH_BORDER
        ph = cfg.affine_window_height + _PATCH_BORDER
        z = jnp.zeros((n, ph, pw), jnp.float32)
        v = jnp.zeros(n, jnp.float32)
        return cls(valid=jnp.zeros(n, bool), img=z, gradx=z, grady=z,
                   x=v, y=v, axx=jnp.ones(n, jnp.float32), ayx=v,
                   axy=v, ayy=jnp.ones(n, jnp.float32))

    def invalidate(self, indices: np.ndarray) -> None:
        if len(indices):
            self.valid = self.valid.at[jnp.asarray(indices)].set(False)


def _extract_patches(img: jax.Array, x: jax.Array, y: jax.Array,
                     ph: int, pw: int) -> jax.Array:
    """Integer-aligned [N, ph, pw] patches centered at trunc(x), trunc(y)
    (reference: _am_getSubFloatImage, src/V1/trackFeatures.c:665-688)."""
    hw, hh = pw // 2, ph // 2
    x0 = x.astype(jnp.int32) - hw
    y0 = y.astype(jnp.int32) - hh

    def one(xs, ys):
        return jax.lax.dynamic_slice(img, (ys, xs), (ph, pw))

    return jax.vmap(one)(x0, y0)


def _corners(axx, ayx, axy, ayy, x2, y2, hw, hh):
    """Warped window corner coordinates (src/V1/trackFeatures.c:1061-1068)."""
    ul_x = axx * (-hw) + axy * hh + x2
    ul_y = ayx * (-hw) + ayy * hh + y2
    ll_x = axx * (-hw) + axy * (-hh) + x2
    ll_y = ayx * (-hw) + ayy * (-hh) + y2
    ur_x = axx * hw + axy * hh + x2
    ur_y = ayx * hw + ayy * hh + y2
    lr_x = axx * hw + axy * (-hh) + x2
    lr_y = ayx * hw + ayy * (-hh) + y2
    return (ul_x, ul_y, ll_x, ll_y, ur_x, ur_y, lr_x, lr_y)


def _coord_oob(c, n):
    return (c < 0.0) | (n - c < _EPS)


# Active-lane compaction for the Gauss-Newton loop: after PRE lockstep
# iterations most lanes have converged, but the while_loop runs every
# remaining iteration at full width for the stragglers.  Gathering the
# still-active lanes into an N/4-wide state and iterating there cuts
# the straggler cost 4x; per-lane math is unchanged (every loop op is
# lane-independent), so results are bit-identical.
_COMPACT = os.environ.get("KLT_AFFINE_COMPACT", "1") != "0"
_COMPACT_PRE = int(os.environ.get("KLT_AFFINE_COMPACT_PRE", "2"))
_GATHER_ONEHOT = os.environ.get("KLT_AFFINE_GATHER", "take") == "onehot"
# resident-patch extraction backend: "ds" (vmapped dynamic_slice block
# gather) or "cb" (one-hot band matmuls); bit-equal, perf differs
_RESIDENT_DS = os.environ.get("KLT_AFFINE_RESIDENT", "cb") == "ds"


def _gather_rows(a, idx):
    """Row gather [N, ...] -> [M, ...] (exact for both backends: take
    is a copy; the one-hot dot is 0/1-weighted at HIGHEST)."""
    if not _GATHER_ONEHOT:
        return jnp.take(a, idx, axis=0)
    n = a.shape[0]
    oh = (idx[:, None] ==
          jnp.arange(n, dtype=jnp.int32)[None, :]).astype(jnp.float32)
    flat = a.reshape(n, -1)
    if a.dtype == jnp.float32:
        out = jnp.dot(oh, flat, precision=_HI,
                      preferred_element_type=jnp.float32)
    else:
        out = jnp.dot(oh, flat.astype(jnp.float32), precision=_HI,
                      preferred_element_type=jnp.float32)
        out = jnp.round(out).astype(a.dtype)
    return out.reshape((idx.shape[0],) + a.shape[1:])


def track_affine(patches, img2, gradx2, grady2, x1, y1, x2_in, y2_in,
                 a_in, active, cfg: TrackingConfig):
    """Batched Gauss-Newton against the saved reference patches.

    patches: (img, gradx, grady) each [N, ph, pw]; img2/grad*2 [H, W]
    — or [B, H, W] for the multi-sequence batched tier, with the lane
    axis flattened seq-major (lane n belongs to sequence n // (N/B));
    x1,y1 [N] patch-frame centers; x2_in,y2_in [N] start positions in
    img2; a_in = (axx, ayx, axy, ayy).  Returns (x2, y2, a_out, status).
    """
    mode = cfg.affine_consistency_check
    aw, ah = cfg.affine_window_width, cfg.affine_window_height
    hw, hh = np.float32(aw // 2), np.float32(ah // 2)
    pimg, pgx, pgy = patches
    ph, pw = pimg.shape[-2], pimg.shape[-1]
    batched = img2.ndim == 3
    nseq = img2.shape[0] if batched else 1
    n_lanes_total = int(x2_in.shape[0])
    seq_ids = (jnp.repeat(jnp.arange(nseq, dtype=jnp.int32),
                          n_lanes_total // nseq) if batched else None)
    nr2, nc2 = img2.shape[-2], img2.shape[-1]
    nc2f, nr2f = np.float32(nc2), np.float32(nr2)
    pcf, prf = np.float32(pw), np.float32(ph)
    area = np.float32(aw * ah)
    th = np.float32(cfg.min_displacement)
    th_aff = np.float32(cfg.affine_min_displacement)
    mdd = np.float32(cfg.affine_max_displacement_differ)

    dxo, dyo = window_offsets(aw, ah)
    dxo, dyo = jnp.asarray(dxo), jnp.asarray(dyo)  # [K]

    # Per-feature RESIDENT image patches, extracted once per call:
    # every in-loop sample (axis-aligned or affine-warped) then reads
    # its own [P, P] patch through _sample_in_patch — no image gathers.
    pres = _RESIDENT
    presf = np.float32(pres)
    have_res = min(nr2, nc2) >= pres
    if have_res:
        pa_x0 = jnp.clip(x2_in.astype(jnp.int32) - pres // 2, 0,
                         nc2 - pres)
        pa_y0 = jnp.clip(y2_in.astype(jnp.int32) - pres // 2, 0,
                         nr2 - pres)
        if _RESIDENT_DS:
            # contiguous block gather: the one-hot band formulation
            # materializes [N*P, 3W] (737 MB at N=2000, P=48); a
            # vmapped dynamic_slice of [3, P, P] blocks moves only the
            # patches themselves (bit-equal — integer-aligned copies)
            if batched:
                st2 = jnp.stack([img2, gradx2, grady2], axis=1)

                def one(b, ys, xs):
                    return jax.lax.dynamic_slice(
                        st2, (b, 0, ys, xs), (1, 3, pres, pres))[0]

                p = jax.vmap(one)(seq_ids, pa_y0, pa_x0)
            else:
                st2 = jnp.stack([img2, gradx2, grady2])

                def one(ys, xs):
                    return jax.lax.dynamic_slice(st2, (0, ys, xs),
                                                 (3, pres, pres))

                p = jax.vmap(one)(pa_y0, pa_x0)
            resid_full = p.transpose(0, 2, 1, 3).reshape(
                -1, pres, 3 * pres)
        elif batched:
            sp2 = jax.vmap(pack_stack_channels)(
                jnp.stack([img2, gradx2, grady2], axis=1))
            # lax.map (not vmap): one sequence's band extraction at a
            # time — the vmapped form materializes the whole batch's
            # one-hot temporaries at once (~4-6 GB at B=8, N=2000,
            # P=32 on 640x480)
            resid_full = jax.lax.map(
                lambda t: extract_packed_cb(t[0], t[1], t[2],
                                            pres, pres),
                (sp2, pa_y0.reshape(nseq, -1),
                 pa_x0.reshape(nseq, -1))
            ).reshape(-1, pres, 3 * pres)
        else:
            sp2 = pack_stack_channels(
                jnp.stack([img2, gradx2, grady2]))
            resid_full = extract_packed_cb(sp2, pa_y0, pa_x0, pres,
                                           pres)
    else:
        resid_full = pa_x0 = pa_y0 = None

    def make_exact_samplers():
        """Full-image gather samplers replicating the reference's
        _interpolate (src/V1/trackFeatures.c:31-57): truncating casts,
        the exact 4-term f32 blend order, any in-image coordinate.
        Used by the escape-repair pass for lanes whose warp/drift
        leaves the resident patch (the reference keeps tracking them
        against the full image; the resident fast path cannot)."""
        flat_i = img2.reshape(-1)
        flat_gx = gradx2.reshape(-1)
        flat_gy = grady2.reshape(-1)
        seq_off = (seq_ids * jnp.int32(nr2 * nc2) if batched else None)

        def samp(flat, xs, ys):
            xt = jnp.clip(xs.astype(jnp.int32), 0, nc2 - 2)
            yt = jnp.clip(ys.astype(jnp.int32), 0, nr2 - 2)
            ax = xs - xt.astype(jnp.float32)
            ay = ys - yt.astype(jnp.float32)
            base = yt * nc2 + xt
            if batched:
                base = base + (seq_off[:, None] if base.ndim == 2
                               else seq_off)
            p00 = jnp.take(flat, base)
            p01 = jnp.take(flat, base + 1)
            p10 = jnp.take(flat, base + nc2)
            p11 = jnp.take(flat, base + nc2 + 1)
            return (((1.0 - ax) * (1.0 - ay)) * p00 +
                    (ax * (1.0 - ay)) * p01 +
                    ((1.0 - ax) * ay) * p10 +
                    (ax * ay) * p11)

        def sample2_img(xs, ys):
            return samp(flat_i, xs, ys)

        def sample2_all(xs, ys):
            return (samp(flat_i, xs, ys), samp(flat_gx, xs, ys),
                    samp(flat_gy, xs, ys))

        def no_oob(c):
            return jnp.zeros_like(c, bool)

        return sample2_img, sample2_all, no_oob, no_oob

    def make_samplers(resid, pax0, pay0, pres_loc=None):
        """Sampler + patch-bound closures over one lane-width's
        operands (full, compacted, or the repair pass's big patches)."""
        if not have_res:
            # image smaller than the resident patch: gather sampling
            def sample2_img(xs, ys):
                return bilinear_sample(img2, xs, ys)

            def sample2_all(xs, ys):
                return (bilinear_sample(img2, xs, ys),
                        bilinear_sample(gradx2, xs, ys),
                        bilinear_sample(grady2, xs, ys))

            def patch_oob_x(c):
                return jnp.zeros_like(c, bool)

            return sample2_img, sample2_all, patch_oob_x, patch_oob_x

        p_loc = pres if pres_loc is None else pres_loc
        p_locf = np.float32(p_loc)
        rimg = resid[:, :, :p_loc]
        pax0f = pax0.astype(jnp.float32)[:, None]
        pay0f = pay0.astype(jnp.float32)[:, None]

        def sample2_img(xs, ys):
            return _sample_in_patch(rimg, xs - pax0f, ys - pay0f)

        def sample2_all(xs, ys):
            return _sample_in_patch3(resid, xs - pax0f, ys - pay0f,
                                     p_loc)

        # A warp+drift that leaves the resident margin would silently
        # read edge-clamped values where the reference reads real
        # image data — mark such features OOB instead (the main pass
        # routes them to the repair pass; the repair pass's far larger
        # margin kills only absurd warps).
        def patch_oob_x(c):
            lc = c - pax0f[:, 0]
            return (lc < 0.0) | (p_locf - lc < _EPS)

        def patch_oob_y(c):
            lc = c - pay0f[:, 0]
            return (lc < 0.0) | (p_locf - lc < _EPS)

        return sample2_img, sample2_all, patch_oob_x, patch_oob_y

    # Patch-side windows are iteration-invariant.
    xs1 = x1[:, None] + dxo[None, :]
    ys1 = y1[:, None] + dyo[None, :]
    g1_full = _sample_in_patch(pimg, xs1, ys1)
    gx1w_full = _sample_in_patch(pgx, xs1, ys1)
    gy1w_full = _sample_in_patch(pgy, xs1, ys1)

    src_oob_full = (_coord_oob(x1 - hw, pcf) | (pcf - (x1 + hw) < _EPS) |
                    _coord_oob(y1 - hh, prf) | (prf - (y1 + hh) < _EPS))

    axx0, ayx0, axy0, ayy0 = a_in

    def warp_coords(axx, ayx, axy, ayy, x2, y2):
        mi = axx[:, None] * dxo[None, :] + axy[:, None] * dyo[None, :]
        mj = ayx[:, None] * dxo[None, :] + ayy[:, None] * dyo[None, :]
        return x2[:, None] + mi, y2[:, None] + mj

    def make_body(samplers, g1, gx1w, gy1w, src_oob):
        _, sample2_all, patch_oob_x, patch_oob_y = samplers

        def body(state):
            x2, y2, axx, ayx, axy, ayy, status, done, esc = state

            if mode == 0:
                oob_ref = (src_oob |
                           (x2 - hw < 0.0) | (nc2f - (x2 + hw) < _EPS) |
                           (y2 - hh < 0.0) | (nr2f - (y2 + hh) < _EPS))
                oob_pat = (patch_oob_x(x2 - hw) | patch_oob_x(x2 + hw) |
                           patch_oob_y(y2 - hh) | patch_oob_y(y2 + hh))
            else:
                cs = _corners(axx, ayx, axy, ayy, x2, y2, hw, hh)
                oob_ref = src_oob
                oob_pat = jnp.zeros_like(src_oob)
                for k in range(0, 8, 2):
                    oob_ref = (oob_ref | _coord_oob(cs[k], nc2f) |
                               _coord_oob(cs[k + 1], nr2f))
                    oob_pat = (oob_pat | patch_oob_x(cs[k]) |
                               patch_oob_y(cs[k + 1]))
            # a lane killed ONLY by the resident-patch margin is an
            # artifact of the fast path — the reference (full-image
            # sampling) keeps it; mark for the exact repair pass
            esc = esc | (~done & oob_pat & ~oob_ref)
            oob = oob_ref | oob_pat
            status = jnp.where(~done & oob, OOB, status)
            done = done | oob

            if mode == 0:
                xs2 = x2[:, None] + dxo[None, :]
                ys2 = y2[:, None] + dyo[None, :]
                g2, gx2s, gy2s = sample2_all(xs2, ys2)
                gx = gx1w + gx2s
                gy = gy1w + gy2s
                diff = g1 - g2
                gxx = jnp.sum(gx * gx, axis=1)
                gxy = jnp.sum(gx * gy, axis=1)
                gyy = jnp.sum(gy * gy, axis=1)
                step = np.float32(cfg.step_factor)
                ex = jnp.sum(diff * gx, axis=1) * step
                ey = jnp.sum(diff * gy, axis=1) * step
                det = gxx * gyy - gxy * gxy
                small = det < np.float32(cfg.min_determinant)
                det_safe = jnp.where(small, 1.0, det)
                dx = (gyy * ex - gxy * ey) / det_safe
                dy = (gxx * ey - gxy * ex) / det_safe
                conv = (jnp.abs(dx) < th) & (jnp.abs(dy) < th)
            else:
                wx, wy = warp_coords(axx, ayx, axy, ayy, x2, y2)
                g2, gx, gy = sample2_all(wx, wy)  # [N,K] each
                diff = g1 - g2

                xi, yj = dxo[None, :], dyo[None, :]
                if mode == 1:  # similarity: (s, r, dx, dy)
                    d_cols = [xi * gx + yj * gy, xi * gy - yj * gx,
                              gx, gy]
                else:  # full affine
                    d_cols = [xi * gx, xi * gy, yj * gx, yj * gy,
                              gx, gy]
                D = jnp.stack(d_cols, axis=-1)  # [N, K, P]
                T = jnp.einsum("nkp,nkq->npq", D, D,
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)
                e = 0.5 * jnp.einsum("nkp,nk->np", D, diff,
                                     preferred_element_type=jnp.float32,
                                     precision=jax.lax.Precision.HIGHEST)

                a, small = _solve_sym_small(T, e)

                old = _corners(axx, ayx, axy, ayy, x2, y2, hw, hh)
                if mode == 1:
                    axx_n = axx + a[:, 0]
                    ayx_n = ayx + a[:, 1]
                    ayy_n = axx_n
                    axy_n = -ayx_n
                    dx, dy = a[:, 2], a[:, 3]
                else:
                    axx_n = axx + a[:, 0]
                    ayx_n = ayx + a[:, 1]
                    axy_n = axy + a[:, 2]
                    ayy_n = ayy + a[:, 3]
                    dx, dy = a[:, 4], a[:, 5]

                upd_ok = ~done & ~small
                axx = jnp.where(upd_ok, axx_n, axx)
                ayx = jnp.where(upd_ok, ayx_n, ayx)
                axy = jnp.where(upd_ok, axy_n, axy)
                ayy = jnp.where(upd_ok, ayy_n, ayy)

                new = _corners(axx, ayx, axy, ayy,
                               x2 + jnp.where(upd_ok, dx, 0.0),
                               y2 + jnp.where(upd_ok, dy, 0.0), hw, hh)
                conv = (jnp.abs(dx) < th) & (jnp.abs(dy) < th)
                for k in range(8):
                    conv = conv & (jnp.abs(old[k] - new[k]) < th_aff)

            status = jnp.where(~done & small, SMALL_DET, status)
            done_after_small = done | small
            x2 = x2 + jnp.where(~done & ~small, dx, 0.0)
            y2 = y2 + jnp.where(~done & ~small, dy, 0.0)
            done = done_after_small | (~done_after_small & conv)
            return x2, y2, axx, ayx, axy, ayy, status, done, esc

        return body

    def run_gn(body, it0, state, max_it):
        """Early-exit while: the body is a masked no-op for converged /
        killed lanes, so stopping when ALL lanes are done is exactly
        the fixed-trip loop's result — real sequences converge in a
        few iterations, not affine_max_iterations."""
        def w_cond(s):
            return jnp.any(~s[1][7]) & (s[0] < max_it)

        def w_body(s):
            nxt = s[0] + 1, body(s[1])
            if os.environ.get("KLT_AFFINE_DEBUG_COUNTS") == "1":
                jax.debug.print("  gn it={i} width={w} active={a}",
                                i=nxt[0], w=nxt[1][7].shape[0],
                                a=jnp.sum((~nxt[1][7]).astype(jnp.int32)))
            return nxt

        return jax.lax.while_loop(w_cond, w_body, (it0, state))

    status0 = jnp.full(x2_in.shape, TRACKED, jnp.int32)
    esc0 = jnp.zeros(x2_in.shape, bool)
    st0 = (x2_in, y2_in, axx0, ayx0, axy0, ayy0, status0, ~active, esc0)

    samp_full = make_samplers(resid_full, pa_x0, pa_y0)
    body_full = make_body(samp_full, g1_full, gx1w_full, gy1w_full,
                          src_oob_full)
    sample2_img = samp_full[0]
    g1 = g1_full

    n_lanes = int(x2_in.shape[0])
    max_it = cfg.affine_max_iterations
    # Staged compaction LADDER.  Measured convergence on laptops
    # (2000 feat/seq, B=8): active lanes decay slowly — 0.45N after
    # it2, 0.29N after it4, 0.14N after it6, 0.08N after it8, and ~5%
    # never converge — so a single narrow compaction never fires and
    # every iteration used to run full-width.  Instead, after the
    # _COMPACT_PRE full-width iterations, each ladder stage compacts
    # the still-active lanes to a fraction of N (with ~25-50% headroom
    # over the measured decay) and runs a couple of iterations there;
    # sampling traffic per iteration is proportional to the stage
    # width, so the ladder cuts the GN loop's HBM bytes ~2.3x.  A
    # stage whose count overflows its width runs those iterations
    # full-width and the next stage re-tries (correctness never
    # depends on the schedule: gather/scatter is lane-exact).
    # KLT_AFFINE_LADDER="iters:frac,..." overrides; the last
    # stage always runs to max_it.
    _ladder_env = os.environ.get(
        "KLT_AFFINE_LADDER", "2:0.5,2:0.375,2:0.1875,9:0.125")
    _stages = [(int(a), float(b)) for a, b in
               (s.split(":") for s in _ladder_env.split(",") if s)]
    do_compact = _COMPACT and _stages and max_it > _COMPACT_PRE

    def compact_run(st_in, it_in, w, it_stop):
        """Run iterations [it_in, it_stop) at compacted width w when
        the active count fits, else at full width."""
        act = ~st_in[7]
        cnt = jnp.sum(act.astype(jnp.int32))
        if os.environ.get("KLT_AFFINE_DEBUG_COUNTS") == "1":
            jax.debug.print("affine ladder cnt_active={c} (w={m})",
                            c=cnt, m=w)
        slots = jnp.cumsum(act.astype(jnp.int32)) - 1
        tgt = jnp.where(act, slots, w)
        idx = jnp.zeros((w,), jnp.int32).at[tgt].set(
            jnp.arange(n_lanes, dtype=jnp.int32), mode="drop")

        def compact_branch(st_in):
            stc = tuple(_gather_rows(a, idx) for a in st_in)
            pad_dead = jnp.arange(w, dtype=jnp.int32) >= cnt
            stc = stc[:7] + (stc[7] | pad_dead, stc[8])
            if have_res:
                samp_c = make_samplers(_gather_rows(resid_full, idx),
                                       _gather_rows(pa_x0, idx),
                                       _gather_rows(pa_y0, idx))
            else:
                samp_c = samp_full  # samplers hold no per-lane state
            body_c = make_body(samp_c,
                               _gather_rows(g1_full, idx),
                               _gather_rows(gx1w_full, idx),
                               _gather_rows(gy1w_full, idx),
                               _gather_rows(src_oob_full, idx))
            _, stc2 = run_gn(body_c, it_in, stc, it_stop)
            sl = jnp.clip(slots, 0, w - 1)
            return tuple(
                jnp.where(act, jnp.take(a_c, sl, axis=0), a_f)
                for a_f, a_c in zip(st_in, stc2))

        def full_branch(st_in):
            _, stf = run_gn(body_full, it_in, st_in, it_stop)
            return stf

        return jax.lax.cond(cnt <= w, compact_branch, full_branch,
                            st_in)

    if not do_compact:
        _, st = run_gn(body_full, jnp.int32(0), st0, max_it)
    else:
        pre = min(_COMPACT_PRE, max_it)
        it_k, st = run_gn(body_full, jnp.int32(0), st0, pre)
        done_iters = pre
        for si, (n_it, frac) in enumerate(_stages):
            if done_iters >= max_it:
                break
            last = (si == len(_stages) - 1)
            stop = max_it if last else min(done_iters + n_it, max_it)
            w = min(-(-int(frac * n_lanes) // 128) * 128, n_lanes)
            w = max(w, 128)
            if w >= n_lanes:
                it_k, st = run_gn(body_full, it_k, st, stop)
            else:
                st = compact_run(st, it_k, w, stop)
                it_k = jnp.int32(stop)
            done_iters = stop

    def finalize(x2, y2, axx, ayx, axy, ayy, status, sample_img_fn, g1_f):
        """Post-loop checks (src/V1/trackFeatures.c:1185-1208):
        axis-aligned window OOB, the SIGNED drift kill, and the
        final-residue test sampled with the converged warp."""
        final_oob = ((x2 - hw < 0.0) | (nc2f - (x2 + hw) < _EPS) |
                     (y2 - hh < 0.0) | (nr2f - (y2 + hh) < _EPS))
        drift = ((x2 - x2_in) > mdd) | ((y2 - y2_in) > mdd)
        status = jnp.where(final_oob | drift, OOB, status)
        if mode == 0:
            xs2 = x2[:, None] + dxo[None, :]
            ys2 = y2[:, None] + dyo[None, :]
            g2 = sample_img_fn(xs2, ys2)
            pat_esc = (samp_oob_x(x2 - hw) | samp_oob_x(x2 + hw) |
                       samp_oob_y(y2 - hh) | samp_oob_y(y2 + hh))
        else:
            wx, wy = warp_coords(axx, ayx, axy, ayy, x2, y2)
            g2 = sample_img_fn(wx, wy)
            # the reference does NOT re-check warped bounds before this
            # sample; a resident-patch read here would be clamped where
            # the reference reads real image data — flag for repair
            pat_esc = jnp.zeros_like(final_oob)
            cs = _corners(axx, ayx, axy, ayy, x2, y2, hw, hh)
            for k in range(0, 8, 2):
                pat_esc = (pat_esc | samp_oob_x(cs[k]) |
                           samp_oob_y(cs[k + 1]))
        residue = jnp.sum(jnp.abs(g1_f - g2), axis=1) / area
        status = jnp.where((status == TRACKED) &
                           (residue > np.float32(cfg.affine_max_residue)),
                           LARGE_RESIDUE, status)
        # A pat_esc lane's g2 came from edge-clamped resident samples,
        # so its residue is garbage — a lane killed LARGE_RESIDUE by it
        # must also route to the repair pass (which re-samples with a
        # far larger margin and recomputes the residue from real data;
        # the reference samples the full image here,
        # src/V1/trackFeatures.c:1195-1205).  OOB/drift kills use only
        # coordinates, never samples, so they stay final.
        return status, pat_esc & ((status == TRACKED) |
                                  (status == LARGE_RESIDUE))

    samp_oob_x, samp_oob_y = samp_full[2], samp_full[3]
    x2, y2, axx, ayx, axy, ayy, status, _, esc = st
    status, esc_final = finalize(x2, y2, axx, ayx, axy, ayy, status,
                                 sample2_img, g1)
    esc = (esc | esc_final) & active

    # Escape-repair pass: lanes whose warp/drift left the resident
    # patch are re-tracked from scratch with a FAR larger per-lane
    # resident patch (KLT_AFFINE_REPAIR_P, default 192 — margin
    # ~89 px vs the main patch's ~17) and overwrite the fast-path
    # result.  Compacted to m_r lanes; big patches move as vmapped
    # dynamic-slice blocks (~56 MB at 128 lanes), and sampling stays
    # on the one-hot-einsum path.  A lane escaping even the repair
    # margin is killed OOB (a warp excursion > ~89 px from center —
    # far beyond anything the drift kill leaves alive).  Lanes beyond
    # m_r escapes fall back to exact full-image gather sampling
    # (pathological; correctness over speed).
    if have_res:
        # per-sequence budget, like m_c above: the escape count is
        # global over [B*N] lanes, and overflowing m_r falls back to
        # the full-width gather repair
        m_r = min(int(os.environ.get("KLT_AFFINE_REPAIR_M",
                                     "128")) * nseq,
                  -(-n_lanes // 128) * 128)
        # default 96: margin ~41 px
        p_rep = min(int(os.environ.get("KLT_AFFINE_REPAIR_P",
                                       "96")), nr2, nc2)

        def repair(args):
            x2_a, y2_a, axx_a, ayx_a, axy_a, ayy_a, status_a = args
            cnt_e = jnp.sum(esc.astype(jnp.int32))
            if os.environ.get("KLT_AFFINE_DEBUG_COUNTS") == "1":
                jax.debug.print("affine cnt_esc={c} (m_r={m})", c=cnt_e,
                                m=m_r)
            slots_e = jnp.cumsum(esc.astype(jnp.int32)) - 1

            def _run_repair(samp_r, st_init, g1_e, gx1w_e, gy1w_e,
                            src_oob_e, x2i, y2i):
                body_e = make_body(samp_r, g1_e, gx1w_e, gy1w_e,
                                   src_oob_e)
                _, stf = run_gn(body_e, jnp.int32(0), st_init, max_it)
                x2e, y2e, axxe, ayxe, axye, ayye, ste = stf[:7]
                final_oob = ((x2e - hw < 0.0) |
                             (nc2f - (x2e + hw) < _EPS) |
                             (y2e - hh < 0.0) |
                             (nr2f - (y2e + hh) < _EPS))
                dr = ((x2e - x2i) > mdd) | ((y2e - y2i) > mdd)
                ste = jnp.where(final_oob | dr, OOB, ste)
                if mode == 0:
                    g2e = samp_r[0](x2e[:, None] + dxo[None, :],
                                    y2e[:, None] + dyo[None, :])
                else:
                    wxe, wye = warp_coords(axxe, ayxe, axye, ayye,
                                           x2e, y2e)
                    g2e = samp_r[0](wxe, wye)
                res_e = jnp.sum(jnp.abs(g1_e - g2e), axis=1) / area
                ste = jnp.where(
                    (ste == TRACKED) &
                    (res_e > np.float32(cfg.affine_max_residue)),
                    LARGE_RESIDUE, ste)
                return x2e, y2e, axxe, ayxe, axye, ayye, ste

            def make_compact_repair(w_r):
              def compact_repair(_):
                tgt_e = jnp.where(esc, slots_e, w_r)
                idx_e = jnp.zeros((w_r,), jnp.int32).at[tgt_e].set(
                    jnp.arange(n_lanes, dtype=jnp.int32), mode="drop")
                pad_dead = jnp.arange(w_r, dtype=jnp.int32) >= cnt_e
                st0_c = tuple(_gather_rows(a, idx_e) for a in st0)
                st0_c = st0_c[:7] + (st0_c[7] | pad_dead, st0_c[8])
                x2i_e = _gather_rows(x2_in, idx_e)
                y2i_e = _gather_rows(y2_in, idx_e)
                # big per-lane resident patches around the pre-track
                # positions of the escaped lanes
                px0_e = jnp.clip(x2i_e.astype(jnp.int32) - p_rep // 2,
                                 0, nc2 - p_rep)
                py0_e = jnp.clip(y2i_e.astype(jnp.int32) - p_rep // 2,
                                 0, nr2 - p_rep)
                if batched:
                    st2 = jnp.stack([img2, gradx2, grady2], axis=1)
                    b_e = _gather_rows(seq_ids, idx_e)

                    def one(b, ys, xs):
                        return jax.lax.dynamic_slice(
                            st2, (b, 0, ys, xs), (1, 3, p_rep, p_rep))[0]

                    pb = jax.vmap(one)(b_e, py0_e, px0_e)
                else:
                    st2 = jnp.stack([img2, gradx2, grady2])

                    def one(ys, xs):
                        return jax.lax.dynamic_slice(
                            st2, (0, ys, xs), (3, p_rep, p_rep))

                    pb = jax.vmap(one)(py0_e, px0_e)
                resid_e = pb.transpose(0, 2, 1, 3).reshape(
                    -1, p_rep, 3 * p_rep)
                samp_r = make_samplers(resid_e, px0_e, py0_e, p_rep)
                rs = _run_repair(
                    samp_r, st0_c, _gather_rows(g1_full, idx_e),
                    _gather_rows(gx1w_full, idx_e),
                    _gather_rows(gy1w_full, idx_e),
                    _gather_rows(src_oob_full, idx_e),
                    x2i_e, y2i_e)
                sl = jnp.clip(slots_e, 0, w_r - 1)
                return tuple(jnp.take(a, sl, axis=0) for a in rs)
              return compact_repair

            def full_repair(_):
                st0_f = st0[:7] + (st0[7] | ~esc, st0[8])
                return _run_repair(
                    make_exact_samplers(), st0_f, g1_full, gx1w_full,
                    gy1w_full, src_oob_full, x2_in, y2_in)

            # two-stage width: the measured escape count is tiny
            # (~20-30 at B=8x2000 lanes), so a narrow 128-lane pass
            # handles virtually every frame at ~1/8 the repair bytes;
            # the per-sequence-scaled m_r catches spikes, and only a
            # pathological frame pays the full-width gather repair
            m_small = min(128, m_r)
            rep_big = (full_repair if m_r <= m_small else
                       lambda a: jax.lax.cond(cnt_e <= m_r,
                                              make_compact_repair(m_r),
                                              full_repair, a))
            rep = jax.lax.cond(cnt_e <= m_small,
                               make_compact_repair(m_small),
                               rep_big, 0)
            return tuple(jnp.where(esc, r, a) for r, a in
                         zip(rep, (x2_a, y2_a, axx_a, ayx_a, axy_a,
                                   ayy_a, status_a)))

        (x2, y2, axx, ayx, axy, ayy, status) = jax.lax.cond(
            jnp.any(esc), repair, lambda a: a,
            (x2, y2, axx, ayx, axy, ayy, status))

    status = jnp.where(active, status, TRACKED)
    return x2, y2, (axx, ayx, axy, ayy), status


def affine_consistency_step(state: AffineState, pyr1_state, pyr2_state,
                            x_old, y_old, val_old, xn, yn, vn,
                            cfg: TrackingConfig):
    """Post-translation-track consistency pass, mutating `state`.

    Mirrors the driver logic at src/V1/trackFeatures.c:1438-1497:
    newly-tracked features save a reference patch; previously-saved
    features are re-verified against it and killed on drift.
    Returns updated (x, y, val).
    """
    from ..utils.knobs import trace_key
    pyr1, gx1, gy1 = pyr1_state
    pyr2, gx2, gy2 = pyr2_state
    out = _affine_step_jit(state.valid, state.img, state.gradx, state.grady,
                           state.x, state.y, state.axx, state.ayx,
                           state.axy, state.ayy,
                           pyr1[0], gx1[0], gy1[0],
                           pyr2[0], gx2[0], gy2[0],
                           x_old, y_old, xn, yn, vn, cfg, trace_key())
    (state.valid, state.img, state.gradx, state.grady, state.x, state.y,
     state.axx, state.ayx, state.axy, state.ayy, x_out, y_out,
     val_out) = out
    return x_out, y_out, val_out


import functools


@functools.partial(jax.jit, static_argnums=(21, 22))
def _affine_step_jit(valid, pimg, pgx, pgy, ax_c, ay_c, axx, ayx, axy, ayy,
                     img1, gradx1, grady1, img2, gradx2, grady2,
                     x_old, y_old, xn, yn, vn, cfg: TrackingConfig,
                     trace_key=None):
    pw = cfg.affine_window_width + _PATCH_BORDER
    ph = cfg.affine_window_height + _PATCH_BORDER

    tracked = vn == TRACKED
    init_mask = tracked & ~valid
    run_mask = tracked & valid

    # Save reference patches for first-time-tracked features at their
    # pre-track position in image 1 (src/V1/trackFeatures.c:1445-1454).
    # Without replacement, init_mask is non-empty only on the FIRST
    # tracked frame (a killed feature never re-validates), so the whole
    # save block — including its patch extraction — is cond-gated.
    def save_patches(args):
        pimg, pgx, pgy, ax_c, ay_c, axx, ayx, axy, ayy = args
        batched = img1.ndim == 3
        nseq = img1.shape[0] if batched else 1
        nr1, nc1 = img1.shape[-2], img1.shape[-1]
        if min(nr1, nc1) >= max(ph, pw):
            px0 = jnp.clip(x_old.astype(jnp.int32) - pw // 2, 0,
                           nc1 - pw)
            py0 = jnp.clip(y_old.astype(jnp.int32) - ph // 2, 0,
                           nr1 - ph)
            if _RESIDENT_DS:
                if batched:
                    st1 = jnp.stack([img1, gradx1, grady1], axis=1)
                    seq_ids = jnp.repeat(
                        jnp.arange(nseq, dtype=jnp.int32),
                        x_old.shape[0] // nseq)

                    def one(b, ys, xs):
                        return jax.lax.dynamic_slice(
                            st1, (b, 0, ys, xs), (1, 3, ph, pw))[0]

                    p3 = jax.vmap(one)(seq_ids, py0, px0)
                else:
                    st1 = jnp.stack([img1, gradx1, grady1])

                    def one(ys, xs):
                        return jax.lax.dynamic_slice(st1, (0, ys, xs),
                                                     (3, ph, pw))

                    p3 = jax.vmap(one)(py0, px0)
                new_img = p3[:, 0]
                new_gx = p3[:, 1]
                new_gy = p3[:, 2]
            else:
                # packed-stack one-hot extraction for all 3 maps
                if batched:
                    sp1 = jax.vmap(pack_stack_channels)(
                        jnp.stack([img1, gradx1, grady1], axis=1))
                    # lax.map for peak-memory control (see the
                    # resident extraction above)
                    newp = jax.lax.map(
                        lambda t: extract_packed_cb(t[0], t[1], t[2],
                                                    ph, pw),
                        (sp1, py0.reshape(nseq, -1),
                         px0.reshape(nseq, -1))
                    ).reshape(-1, ph, 3 * pw)
                else:
                    sp1 = pack_stack_channels(jnp.stack([img1, gradx1,
                                                         grady1]))
                    newp = extract_packed_cb(sp1, py0, px0, ph, pw)
                new_img = newp[:, :, :pw]
                new_gx = newp[:, :, pw:2 * pw]
                new_gy = newp[:, :, 2 * pw:]
        else:
            new_img = _extract_patches(img1, x_old, y_old, ph, pw)
            new_gx = _extract_patches(gradx1, x_old, y_old, ph, pw)
            new_gy = _extract_patches(grady1, x_old, y_old, ph, pw)
        m3 = init_mask[:, None, None]
        pimg = jnp.where(m3, new_img, pimg)
        pgx = jnp.where(m3, new_gx, pgx)
        pgy = jnp.where(m3, new_gy, pgy)
        frac_x = x_old - x_old.astype(jnp.int32).astype(jnp.float32)
        frac_y = y_old - y_old.astype(jnp.int32).astype(jnp.float32)
        ax_c = jnp.where(init_mask, frac_x + pw // 2, ax_c)
        ay_c = jnp.where(init_mask, frac_y + ph // 2, ay_c)
        axx = jnp.where(init_mask, 1.0, axx)
        ayx = jnp.where(init_mask, 0.0, ayx)
        axy = jnp.where(init_mask, 0.0, axy)
        ayy = jnp.where(init_mask, 1.0, ayy)
        return pimg, pgx, pgy, ax_c, ay_c, axx, ayx, axy, ayy

    (pimg, pgx, pgy, ax_c, ay_c, axx, ayx, axy, ayy) = jax.lax.cond(
        jnp.any(init_mask), save_patches, lambda a: a,
        (pimg, pgx, pgy, ax_c, ay_c, axx, ayx, axy, ayy))

    # Verify features that already have a reference patch.
    x2, y2, (axx_r, ayx_r, axy_r, ayy_r), st = track_affine(
        (pimg, pgx, pgy), img2, gradx2, grady2, ax_c, ay_c, xn, yn,
        (axx, ayx, axy, ayy), run_mask, cfg)

    killed = run_mask & (st != TRACKED)
    x_out = jnp.where(killed, jnp.float32(-1.0), xn)
    y_out = jnp.where(killed, jnp.float32(-1.0), yn)
    val_out = jnp.where(run_mask, st, vn)

    keep = run_mask & (st == TRACKED)
    axx = jnp.where(keep, axx_r, axx)
    ayx = jnp.where(keep, ayx_r, ayx)
    axy = jnp.where(keep, axy_r, axy)
    ayy = jnp.where(keep, ayy_r, ayy)

    valid = jnp.where(tracked, jnp.where(valid, st == TRACKED, True), False)
    ax_c = jnp.where(killed, jnp.float32(-1.0), ax_c)
    ay_c = jnp.where(killed, jnp.float32(-1.0), ay_c)
    return (valid, pimg, pgx, pgy, ax_c, ay_c, axx, ayx, axy, ayy,
            x_out, y_out, val_out)
