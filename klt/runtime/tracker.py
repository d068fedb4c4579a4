"""High-level tracker runtime.

`KLTracker` is the equivalent of the reference's
KLT_TrackingContext + entry points (KLTSelectGoodFeatures /
KLTTrackFeatures / KLTReplaceLostFeatures, src/V1/klt.h:150-169):

* the heavy pipeline (uint8 -> smooth -> pyramid -> gradients -> batched
  coarse-to-fine LK) runs as one jitted XLA program per image shape;
* sequential mode keeps the previous frame's pyramids device-resident
  between calls — the V3 lesson (src/V3/trackFeaturesGPU.cu:481-484):
  never round-trip frames through the host;
* selection computes the corner-response map with the integer-exact
  host chain (ops/exact_select.py — the (int)-cast sort makes selection
  ulp-sensitive, see that module; KLT_EXACT_SELECT=0 reverts to the
  device response) and hands the candidate list to the native host
  runtime for the tie-exact sort and greedy suppression (mirroring the
  reference's CPU-side selection); sequential-mode replacement keeps
  the device response from the cached tracking gradients, as the
  reference reuses tc->pyramid_last (src/V1/selectGoodFeatures.c:342).
"""

from __future__ import annotations

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TrackingConfig, NOT_FOUND
from ..features import FeatureList
from ..ops.convolve import compute_smoothed_image, compute_gradients
from ..ops.pyramid import build_image_pyramids
from ..utils.knobs import trace_key
from ..ops.selection import (corner_response, candidate_points,
                             candidate_points_topk,
                             selection_prefilter_audit)
from ..ops.lk import track_features_pyramid
from ..ops.affine import AffineState, affine_consistency_step
from .. import native

_verbosity = 1


def _exact_select_enabled() -> bool:
    """Integer-exact host selection response (default on); KLT_EXACT_SELECT=0
    falls back to the device response map."""
    import os
    return os.environ.get("KLT_EXACT_SELECT", "1") != "0"


def set_verbosity(level: int) -> None:
    """reference: KLTSetVerbosity, src/V1/klt.c:524-528."""
    global _verbosity
    _verbosity = level


def _log(msg: str) -> None:
    if _verbosity >= 1:
        print(msg, file=sys.stderr, flush=True)


class KLTracker:
    """Stateful tracker bound to one TrackingConfig."""

    def __init__(self, cfg: TrackingConfig | None = None):
        self.cfg = cfg or TrackingConfig()
        self.sequential = self.cfg.sequential_mode
        self._pyr_last = None  # (pyr, gradx, grady) tuples of device arrays
        self._affine = None    # AffineState for consistency checking
        # lighting_insensitive + affine check is a valid combination:
        # the reference's affine stage simply runs without gain/bias
        # normalization (src/V1/trackFeatures.c:952-1220 has no lighting
        # terms), while the translation stage keeps it.

    # ------------------------------------------------------------- #
    # jitted pipelines (cached per image shape)                      #
    # ------------------------------------------------------------- #

    @functools.cached_property
    def _pyramids_jit(self):
        cfg = self.cfg

        @functools.partial(jax.jit, static_argnums=1)
        def fn(img, trace_key=None):
            pyr, gx, gy = build_image_pyramids(img, cfg)
            return tuple(pyr), tuple(gx), tuple(gy)

        return fn

    @functools.cached_property
    def _response_jit(self):
        cfg = self.cfg

        @functools.partial(jax.jit, static_argnums=1)
        def fn(img, trace_key=None):
            fi = img.astype(jnp.float32)
            if cfg.smooth_before_selecting:
                fi = compute_smoothed_image(fi, cfg.smooth_sigma)
            gx, gy = compute_gradients(fi, cfg.grad_sigma)
            return corner_response(gx, gy, cfg.window_width,
                                   cfg.window_height)

        return fn

    @functools.cached_property
    def _response_from_maps_jit(self):
        cfg = self.cfg

        @functools.partial(jax.jit, static_argnums=2)
        def fn(gx, gy, trace_key=None):
            return corner_response(gx, gy, cfg.window_width,
                                   cfg.window_height)

        return fn

    @functools.cached_property
    def _track_jit(self):
        cfg = self.cfg

        @functools.partial(jax.jit, static_argnums=7)
        def fn(pyr1, gx1, gy1, img2, x, y, val, trace_key=None):
            pyr2, gx2, gy2 = build_image_pyramids(img2, cfg)
            xn, yn, vn = track_features_pyramid(
                list(pyr1), list(gx1), list(gy1), pyr2, gx2, gy2,
                x, y, val, cfg)
            return xn, yn, vn, (tuple(pyr2), tuple(gx2), tuple(gy2))

        return fn

    # ------------------------------------------------------------- #
    # public API                                                     #
    # ------------------------------------------------------------- #

    def select_good_features(self, img: np.ndarray, fl: FeatureList) -> None:
        """reference: KLTSelectGoodFeatures, src/V1/selectGoodFeatures.c:472."""
        _log(f"(KLT) Selecting the {fl.n_features} best features from a "
             f"{img.shape[1]} by {img.shape[0]} image...")
        self._select(img, fl, overwrite_all=True)
        _log(f"\t{fl.count_remaining()} features found.")

    def replace_lost_features(self, img: np.ndarray, fl: FeatureList) -> None:
        """reference: KLTReplaceLostFeatures,
        src/V1/selectGoodFeatures.c:514-541."""
        n_lost = fl.n_features - fl.count_remaining()
        _log(f"(KLT) Attempting to replace {n_lost} features...")
        if n_lost > 0:
            self._select(img, fl, overwrite_all=False)

    def _select(self, img: np.ndarray, fl: FeatureList,
                overwrite_all: bool) -> None:
        nrows, ncols = img.shape
        cfg = self.cfg

        if (not overwrite_all and self.sequential
                and self._pyr_last is not None):
            # Replacement in sequential mode reuses the cached pyramid's
            # finest level and its gradients
            # (reference: src/V1/selectGoodFeatures.c:342-348).
            _, gx_pyr, gy_pyr = self._pyr_last
            response = self._response_from_maps_jit(gx_pyr[0], gy_pyr[0],
                                                    trace_key())
        elif _exact_select_enabled():
            # Integer-exact host response: the (int) cast + sort make
            # selection ulp-sensitive; the exact chain reproduces the
            # reference's picks at any depth (see ops/exact_select.py).
            from ..ops.exact_select import selection_response_exact
            response = selection_response_exact(np.asarray(img), cfg)
        else:
            response = self._response_jit(jnp.asarray(img), trace_key())

        newly = None if overwrite_all else (fl.val < 0)
        if not self._suppress_prefiltered(response, fl, ncols, nrows,
                                          overwrite_all):
            pts = candidate_points(np.asarray(response), cfg, ncols,
                                   nrows)
            native.sort_points_desc(pts)
            native.min_dist_suppress(pts, fl.x, fl.y, fl.val, ncols,
                                     nrows, cfg.mindist,
                                     cfg.min_eigenvalue, overwrite_all)
        # Reset affine reference patches for (re)selected features.
        if cfg.affine_consistency_check >= 0 and self._affine is not None:
            reset = np.ones(fl.n_features, bool) if overwrite_all else newly
            self._affine.invalidate(np.nonzero(reset)[0])

    def _suppress_prefiltered(self, response, fl: FeatureList,
                              ncols: int, nrows: int,
                              overwrite_all: bool) -> bool:
        """Run sort + suppression on the device-prefiltered candidate
        list; True on success.  Falls back (returns False, feature list
        restored) when the exactness audit cannot certify that the
        reduced list yields the full list's outcome — so results stay
        golden-exact while a certified call transfers O(k * nCells)
        triples instead of the full response map.

        Opt-in (KLT_PREFILTER=1): measured on the bundled scenes,
        the audit can certify only shallow selections (selection
        boundaries on real imagery sit far below the per-cell rank-k
        values, and the reference's full-array quicksort tie order is
        unreproducible on a reduced list), so by default the tracker
        keeps the always-exact full path.  High-rate replacement
        pipelines should use the device-resident replacement in
        ops/replace.py instead, which never round-trips to the host.
        Reference contract: src/V1/selectGoodFeatures.c:135-239."""
        import os
        cfg = self.cfg
        if cfg.mindist < 2 or not os.environ.get("KLT_PREFILTER"):
            return False
        pts, dropped_cells = candidate_points_topk(response, cfg, ncols,
                                                   nrows)
        save = (fl.x.copy(), fl.y.copy(), fl.val.copy())
        native.sort_points_desc(pts)
        native.min_dist_suppress(pts, fl.x, fl.y, fl.val, ncols, nrows,
                                 cfg.mindist, cfg.min_eigenvalue,
                                 overwrite_all)
        target = np.ones(fl.n_features, bool) if overwrite_all \
            else (save[2] < 0)
        added = target & (fl.val >= 0)  # every target slot now filled
        n_unfilled = int((target & (fl.val < 0)).sum())
        exist = np.zeros(0, bool) if overwrite_all else (save[2] >= 0)
        ok = selection_prefilter_audit(
            pts, dropped_cells, fl.val[added],
            fl.x[added].astype(np.int32), fl.y[added].astype(np.int32),
            save[0][exist].astype(np.int32) if exist.any()
            else np.empty(0, np.int32),
            save[1][exist].astype(np.int32) if exist.any()
            else np.empty(0, np.int32),
            n_unfilled, cfg)
        if not ok:
            fl.x[:], fl.y[:], fl.val[:] = save
        return ok

    def track_features(self, img1: np.ndarray, img2: np.ndarray,
                       fl: FeatureList) -> None:
        """reference: KLTTrackFeatures, src/V1/trackFeatures.c:1234-1529."""
        _log(f"(KLT) Tracking {fl.count_remaining()} features in a "
             f"{img2.shape[1]} by {img2.shape[0]} image...")
        cfg = self.cfg

        if self.sequential and self._pyr_last is not None:
            pyr1, gx1, gy1 = self._pyr_last
            if pyr1[0].shape != img2.shape:
                raise ValueError(
                    f"incoming image {img2.shape} differs from previous "
                    f"image {pyr1[0].shape}")
        else:
            pyr1, gx1, gy1 = self._pyramids_jit(jnp.asarray(img1),
                                                trace_key())

        xn, yn, vn, pyr2_state = self._track_jit(
            pyr1, gx1, gy1, jnp.asarray(img2),
            jnp.asarray(fl.x), jnp.asarray(fl.y), jnp.asarray(fl.val),
            trace_key())

        if cfg.affine_consistency_check >= 0:
            if self._affine is None:
                self._affine = AffineState.create(fl.n_features, cfg)
            xn, yn, vn = affine_consistency_step(
                self._affine, (pyr1, gx1, gy1), pyr2_state,
                jnp.asarray(fl.x), jnp.asarray(fl.y), jnp.asarray(fl.val),
                xn, yn, vn, cfg)

        fl.x[:] = np.asarray(xn)
        fl.y[:] = np.asarray(yn)
        fl.val[:] = np.asarray(vn)

        if self.sequential:
            self._pyr_last = pyr2_state
        _log(f"\t{fl.count_remaining()} features successfully tracked.")

    def stop_sequential_mode(self) -> None:
        """reference: KLTStopSequentialMode, src/V1/klt.c:490-500."""
        self._pyr_last = None
        self.sequential = False
