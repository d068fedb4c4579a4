"""Shi-Tomasi (min-eigenvalue) corner response and candidate extraction.

The dense structure-tensor scan (reference:
src/V1/selectGoodFeatures.c:394-424 — a window^2 loop per pixel) becomes
two separable box-filter convolutions over the gradient product maps, an
O(HW) bandwidth-bound pass that XLA fuses.  The inherently sequential
pieces — the tie-exact descending sort and the greedy minimum-distance
suppression — run in the native host runtime (klt/native), mirroring
the reference's own split where even the V3 GPU build keeps selection's
scalar logic on the CPU (src/V3/Makefile:23-24).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TrackingConfig
from .convolve import _conv1d

_INT_LIMIT = np.float32(2147483583.0)  # largest f32 below 2^31-1
_INT_MIN = -2 ** 31


def corner_response(gradx: jax.Array, grady: jax.Array,
                    window_width: int, window_height: int) -> jax.Array:
    """Min-eigenvalue map of the windowed structure tensor.

    Valid wherever the window is fully interior; the candidate extractor
    only reads inside the border margin, matching the reference's scan
    bounds (src/V1/selectGoodFeatures.c:396-397).
    """
    ones_w = np.ones(window_width, dtype=np.float32)
    ones_h = np.ones(window_height, dtype=np.float32)

    def box(img):
        return _conv1d(_conv1d(img, ones_w, axis=1), ones_h, axis=0)

    gxx = box(gradx * gradx)
    gxy = box(gradx * grady)
    gyy = box(grady * grady)

    # reference: _minEigenvalue, src/V1/selectGoodFeatures.c:289-292
    lam = (gxx + gyy -
           jnp.sqrt((gxx - gyy) * (gxx - gyy) + 4.0 * gxy * gxy)) / 2.0
    return jnp.minimum(lam, _INT_LIMIT)  # int-capacity clamp (:415-420)


def _candidate_borders(cfg: TrackingConfig):
    window_hw = cfg.window_width // 2
    window_hh = cfg.window_height // 2
    return (max(cfg.borderx, window_hw), max(cfg.bordery, window_hh),
            cfg.n_skipped_pixels + 1)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _cell_topk_device(response, cell: int, k: int, borderx: int,
                      bordery: int, step: int):
    """Per-cell top-(k+1) of the truncated response over aligned
    (cell x cell) tiles; invalid (border / off-step) pixels carry
    INT_MIN.  Returns (vals [nCells, kk], in-cell flat idx [nCells, kk])
    with kk = min(k+1, cell*cell) — the extra rank feeds the host-side
    exactness audit (the best value each cell DROPPED)."""
    h, w = response.shape
    vals = response.astype(jnp.int32)  # C (int) cast: trunc toward zero
    yi = jnp.arange(h, dtype=jnp.int32)[:, None]
    xi = jnp.arange(w, dtype=jnp.int32)[None, :]
    valid = ((yi >= bordery) & (yi < h - bordery) &
             (xi >= borderx) & (xi < w - borderx))
    if step > 1:
        valid &= (((yi - bordery) % step) == 0) & \
                 (((xi - borderx) % step) == 0)
    vals = jnp.where(valid, vals, _INT_MIN)
    ph, pw = (-h) % cell, (-w) % cell
    if ph or pw:
        vals = jnp.pad(vals, ((0, ph), (0, pw)),
                       constant_values=_INT_MIN)
    ncy, ncx = (h + ph) // cell, (w + pw) // cell
    cells = vals.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell * cell)
    kk = min(k + 1, cell * cell)
    return jax.lax.top_k(cells, kk)


def candidate_points_topk(response, cfg: TrackingConfig, ncols: int,
                          nrows: int, k: int = 4):
    """Device-side candidate prefilter: the k best candidates per
    aligned (mindist x mindist) cell, transferring O(k * nCells)
    triples to the host instead of the full response map.

    The suppression stamp covers Chebyshev radius mindist-1
    (reference: _fillFeaturemap after the mindist-- at
    src/V1/selectGoodFeatures.c:162-168), so at most ONE candidate per
    cell can ever be accepted; k > 1 covers candidates whose cell-mates
    were stamped from neighboring cells.  Exactness vs the full list is
    certified per call by `selection_prefilter_audit`; callers fall
    back to `candidate_points` when the audit fails.

    Returns (pts int32 [m, 3] of (x, y, val) with val >= 1,
    dropped_cells int32 [d, 3] of (cell_x0, cell_y0, best dropped value)
    for every cell that excluded at least one addable candidate).
    """
    cell = max(int(cfg.mindist), 1)
    borderx, bordery, step = _candidate_borders(cfg)
    top, idx = _cell_topk_device(response, cell, k, borderx, bordery,
                                 step)
    top = np.asarray(top)
    idx = np.asarray(idx)
    kk = top.shape[1]
    use = min(k, kk)
    ncx = (ncols + (-ncols) % cell) // cell
    cy = (np.arange(top.shape[0], dtype=np.int32) // ncx) * cell
    cx = (np.arange(top.shape[0], dtype=np.int32) % ncx) * cell
    ys = idx[:, :use] // cell + cy[:, None]
    xs = idx[:, :use] % cell + cx[:, None]
    v = top[:, :use]
    keep = v >= 1  # sub-1 values can never be added (min_eig floor)
    pts = np.stack([xs[keep], ys[keep], v[keep]], axis=1).astype(np.int32)
    if kk > k:
        dmask = top[:, k] >= 1
        dropped_cells = np.stack(
            [cx[dmask], cy[dmask], top[:, k][dmask]],
            axis=1).astype(np.int32)
    else:
        dropped_cells = np.empty((0, 3), np.int32)
    return pts, dropped_cells


def selection_prefilter_audit(pts: np.ndarray, dropped_cells: np.ndarray,
                              added_vals: np.ndarray,
                              added_x: np.ndarray, added_y: np.ndarray,
                              exist_x: np.ndarray, exist_y: np.ndarray,
                              n_unfilled: int, cfg: TrackingConfig) -> bool:
    """True iff the reduced-list selection outcome provably equals the
    full-list one.

    Let floor = max(1, min_eigenvalue), stamp = mindist-1 (the Chebyshev
    suppression radius), and v_boundary = the value of the LAST slot
    filled (selections happen in descending value order), or floor when
    slots stayed empty.  Exactness holds when:

      1. every cell that dropped an addable candidate with best dropped
         value m >= v_boundary is COVERED: it contains a pre-existing
         feature, or an accepted point with value > m.  A cell's side
         equals mindist, so any in-cell point stamps the entire cell —
         the dropped candidates were dead before their turn.
      2. among kept candidates >= v_boundary that are NOT provably dead
         on arrival (stamped by a pre-existing feature or by an accepted
         point of strictly larger value), equal-valued groups must be
         pairwise non-interacting (Chebyshev > stamp) and a group at
         exactly v_boundary must be fully accepted — otherwise the
         reference's tie order (a full-array quicksort permutation the
         reduced array cannot reproduce) could pick different members.
    """
    floor = max(1, int(cfg.min_eigenvalue))
    stamp = max(int(cfg.mindist) - 1, 0)
    if n_unfilled > 0:
        v_boundary = floor
    else:
        v_boundary = int(added_vals.min()) if added_vals.size else floor

    def covered_by_existing(x, y):
        if exist_x.size == 0:
            return np.zeros(x.shape, bool)
        dx = np.abs(x[:, None] - exist_x[None, :])
        dy = np.abs(y[:, None] - exist_y[None, :])
        return (np.maximum(dx, dy) <= stamp).any(axis=1)

    # 1. dropped-cell coverage
    hotc = dropped_cells[dropped_cells[:, 2] >= v_boundary]
    if hotc.shape[0]:
        cell = max(int(cfg.mindist), 1)
        in_cell_exist = np.zeros(hotc.shape[0], bool)
        if exist_x.size:
            in_cell_exist = (
                (exist_x[None, :] >= hotc[:, 0][:, None]) &
                (exist_x[None, :] < hotc[:, 0][:, None] + cell) &
                (exist_y[None, :] >= hotc[:, 1][:, None]) &
                (exist_y[None, :] < hotc[:, 1][:, None] + cell)
            ).any(axis=1)
        in_cell_added = np.zeros(hotc.shape[0], bool)
        if added_x.size:
            in_cell_added = (
                (added_x[None, :] >= hotc[:, 0][:, None]) &
                (added_x[None, :] < hotc[:, 0][:, None] + cell) &
                (added_y[None, :] >= hotc[:, 1][:, None]) &
                (added_y[None, :] < hotc[:, 1][:, None] + cell) &
                (added_vals[None, :] > hotc[:, 2][:, None])
            ).any(axis=1)
        if not (in_cell_exist | in_cell_added).all():
            return False

    # 2. tie safety among live kept candidates
    hot = pts[pts[:, 2] >= v_boundary]
    if hot.shape[0] <= 1:
        return True
    doa = covered_by_existing(hot[:, 0], hot[:, 1])
    if added_x.size:
        dx = np.abs(hot[:, 0][:, None] - added_x[None, :])
        dy = np.abs(hot[:, 1][:, None] - added_y[None, :])
        doa |= ((np.maximum(dx, dy) <= stamp) &
                (added_vals[None, :] > hot[:, 2][:, None])).any(axis=1)
    live = hot[~doa]
    if live.shape[0] <= 1:
        return True
    uniq, counts = np.unique(live[:, 2], return_counts=True)
    added_set = {(int(x), int(y)) for x, y in zip(added_x, added_y)}
    for v in uniq[counts > 1]:
        grp = live[live[:, 2] == v]
        dx = np.abs(grp[:, 0][:, None] - grp[:, 0][None, :])
        dy = np.abs(grp[:, 1][:, None] - grp[:, 1][None, :])
        cheb = np.maximum(dx, dy)
        np.fill_diagonal(cheb, stamp + 1)
        if (cheb <= stamp).any():
            return False
        if v == v_boundary and n_unfilled == 0:
            if not all((int(x), int(y)) in added_set
                       for x, y in zip(grp[:, 0], grp[:, 1])):
                return False
    return True


def candidate_points(response: np.ndarray, cfg: TrackingConfig,
                     ncols: int, nrows: int) -> np.ndarray:
    """Host-side pointlist [(x, y, int(val)), ...] in the reference's
    row-major scan order (src/V1/selectGoodFeatures.c:394-424).

    Returns int32 [n, 3].  Truncation toward zero matches the C cast.
    """
    borderx, bordery, step = _candidate_borders(cfg)

    ys = np.arange(bordery, nrows - bordery, step, dtype=np.int32)
    xs = np.arange(borderx, ncols - borderx, step, dtype=np.int32)
    vals = np.asarray(response)[np.ix_(ys, xs)].astype(np.int32)  # trunc

    gx, gy = np.meshgrid(xs, ys)
    pts = np.empty((vals.size, 3), dtype=np.int32)
    pts[:, 0] = gx.ravel()
    pts[:, 1] = gy.ravel()
    pts[:, 2] = vals.ravel()
    return pts
