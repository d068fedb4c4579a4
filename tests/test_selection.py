"""Feature selection vs the CPU oracle + native runtime unit tests."""

import numpy as np

import klt
from klt import native
from conftest import load_xyv


def test_native_sort_descending_and_permutation():
    rng = np.random.RandomState(7)
    pts = np.stack([rng.randint(0, 100, 5000),
                    rng.randint(0, 100, 5000),
                    rng.randint(0, 50, 5000)], axis=1).astype(np.int32)
    orig = pts.copy()
    native.sort_points_desc(pts)
    assert np.all(np.diff(pts[:, 2]) <= 0)
    # same multiset of rows
    a = orig[np.lexsort(orig.T)]
    b = pts[np.lexsort(pts.T)]
    np.testing.assert_array_equal(a, b)


def test_native_suppression_min_distance():
    rng = np.random.RandomState(3)
    n = 2000
    pts = np.stack([rng.randint(0, 200, n), rng.randint(0, 150, n),
                    rng.randint(1, 10000, n)], axis=1).astype(np.int32)
    native.sort_points_desc(pts)
    fx = np.full(100, -1.0, np.float32)
    fy = np.full(100, -1.0, np.float32)
    fval = np.full(100, -1, np.int32)
    native.min_dist_suppress(pts, fx, fy, fval, 200, 150, mindist=10,
                             min_eigenvalue=1, overwrite_all=True)
    sel = fval >= 0
    xs, ys = fx[sel], fy[sel]
    # pairwise Chebyshev distance >= mindist-1 honoring the reference's
    # mindist-- convention (src/V1/selectGoodFeatures.c:157)
    for i in range(len(xs)):
        d = np.maximum(np.abs(xs - xs[i]), np.abs(ys - ys[i]))
        d[i] = 1e9
        assert d.min() > 9


def test_selection_matches_oracle(provided_frames):
    tr = klt.KLTracker(klt.TrackingConfig())
    fl = klt.FeatureList.create(150)
    tr.select_good_features(provided_frames[0], fl)

    ox, oy, ov = load_xyv("select_img0.xyv")
    # integer-exact with the host-exact response path (default)
    np.testing.assert_array_equal(fl.x, ox)
    np.testing.assert_array_equal(fl.y, oy)
    np.testing.assert_array_equal(fl.val, ov)


def test_exact_conv_bit_matches_reference(provided_frames):
    """The exact host chain reproduces the C-dumped smoothing/gradient
    fixtures BIT-for-bit (not just within tolerance): same f32
    accumulation order as src/V1/convolve.c:137-242."""
    from klt.ops.exact_select import (smoothed_image_exact,
                                          gradients_exact)
    from conftest import load_f32
    cfg = klt.TrackingConfig()
    img = provided_frames[0].astype(np.float32)
    sm = smoothed_image_exact(img, cfg.smooth_sigma)
    np.testing.assert_array_equal(sm, load_f32("smoothed_img0.f32",
                                               sm.shape))
    gx, gy = gradients_exact(sm, cfg.grad_sigma)
    np.testing.assert_array_equal(gx, load_f32("gradx_img0.f32", gx.shape))
    np.testing.assert_array_equal(gy, load_f32("grady_img0.f32", gy.shape))


def test_exact_select_laptops_seed_matches_reference_table():
    """Regression for the round-3 laptops-affine parity failure: the
    2000-deep selection on images_laptops img1 must equal the reference
    run's frame-0 column exactly (the device response's reduction-order
    ulps flipped (int) casts and reordered the sort at this depth)."""
    import os
    import pytest
    from conftest import REF_DATA, fixture_path
    from klt.io.features_io import read_feature_table
    img_path = os.path.join(REF_DATA, "images_laptops", "img1.pgm")
    if not os.path.exists(img_path):
        pytest.skip("images_laptops dataset not available")
    cfg = klt.TrackingConfig(sequential_mode=True,
                             affine_consistency_check=2,
                             n_pyramid_levels=4, subsampling=2)
    tr = klt.KLTracker(cfg)
    fl = klt.FeatureList.create(2000)
    tr.select_good_features(klt.read_pgm(img_path), fl)
    oracle = read_feature_table(fixture_path("table_laptops_2000aff.ft"))
    np.testing.assert_array_equal(fl.x, oracle.x[:, 0])
    np.testing.assert_array_equal(fl.y, oracle.y[:, 0])
    np.testing.assert_array_equal(fl.val, oracle.val[:, 0])


def test_replacement_keeps_live_features(provided_frames):
    tr = klt.KLTracker(klt.TrackingConfig())
    fl = klt.FeatureList.create(100)
    tr.select_good_features(provided_frames[0], fl)
    # kill 30 features
    kill = np.arange(0, 100, 3)
    fl.val[kill] = klt.OOB
    fl.x[kill] = fl.y[kill] = -1.0
    keep_x = fl.x.copy()
    tr.replace_lost_features(provided_frames[0], fl)
    live = np.setdiff1d(np.arange(100), kill)
    np.testing.assert_array_equal(fl.x[live], keep_x[live])
    assert fl.count_remaining() > 70  # killed slots mostly refilled
    # refilled features respect min distance from kept ones
    sel = fl.val >= 0
    xs, ys = fl.x[sel], fl.y[sel]
    for i in range(len(xs)):
        d = np.maximum(np.abs(xs - xs[i]), np.abs(ys - ys[i]))
        d[i] = 1e9
        assert d.min() > tr.cfg.mindist - 1


def test_prefilter_candidates_subset_and_audit(provided_frames,
                                               monkeypatch):
    """candidate_points_topk keeps a value-correct subset of the full
    candidate list, and the opt-in prefiltered selection path either
    certifies exactness or falls back — producing the full path's
    result either way."""
    import jax.numpy as jnp
    from klt.ops.selection import (candidate_points,
                                       candidate_points_topk)

    cfg = klt.TrackingConfig()
    tr = klt.KLTracker(cfg)
    img = provided_frames[0]
    response = tr._response_jit(jnp.asarray(img))
    full = candidate_points(np.asarray(response), cfg, img.shape[1],
                            img.shape[0])
    pts, dropped = candidate_points_topk(response, cfg, img.shape[1],
                                         img.shape[0])
    # every kept triple appears in the full list
    full_set = {tuple(r) for r in full.tolist()}
    assert all(tuple(r) in full_set for r in pts.tolist())
    # per cell at most k entries and values are the cell's best
    assert pts.shape[0] < full.shape[0]
    assert (pts[:, 2] >= 1).all()

    # the opt-in prefiltered path must equal the full path exactly
    # (via certification or fallback)
    monkeypatch.setenv("KLT_PREFILTER", "1")
    fl_a = klt.FeatureList.create(150)
    tr_a = klt.KLTracker(cfg)
    tr_a.select_good_features(img, fl_a)
    monkeypatch.delenv("KLT_PREFILTER")
    fl_b = klt.FeatureList.create(150)
    tr_b = klt.KLTracker(cfg)
    tr_b.select_good_features(img, fl_b)
    np.testing.assert_array_equal(fl_a.x, fl_b.x)
    np.testing.assert_array_equal(fl_a.y, fl_b.y)
    np.testing.assert_array_equal(fl_a.val, fl_b.val)


def test_prefilter_audit_certifies_replacement():
    """Replacement on a scene of isolated distinct-valued corners: the
    boundary sits at the strongest unclaimed corner, dropped cells are
    either below it or covered by existing/added features, so the audit
    must certify (no fallback) and match the full path."""
    import os
    import klt.runtime.tracker as T
    from klt.config import TrackingConfig

    rng = np.random.RandomState(11)
    img = rng.randint(98, 102, (120, 160)).astype(np.uint8)
    for i, (cy, cx) in enumerate([(30, 40), (60, 100), (90, 50),
                                  (40, 130), (80, 20)]):
        amp = 60 + 20 * i
        img[cy:cy + 6, cx:cx + 6] = 100 + amp
        img[cy + 3:cy + 6, cx:cx + 3] = 100 - amp // 2
    cfg = TrackingConfig()

    def select_then_lose():
        tr = T.KLTracker(cfg)
        fl = klt.FeatureList.create(4)
        tr.select_good_features(img, fl)
        assert (fl.val >= 0).sum() == 4
        fl.val[2] = -1  # lose one feature; replacement refills it
        return tr, fl

    calls = {"ok": 0, "fb": 0}
    orig = T.KLTracker._suppress_prefiltered

    def wrap(self, *a, **k):
        r = orig(self, *a, **k)
        calls["ok" if r else "fb"] += 1
        return r

    os.environ["KLT_PREFILTER"] = "1"
    T.KLTracker._suppress_prefiltered = wrap
    try:
        tr, fl = select_then_lose()
        tr.replace_lost_features(img, fl)
    finally:
        T.KLTracker._suppress_prefiltered = orig
        os.environ.pop("KLT_PREFILTER")
    # the initial (deep) selection may fall back; the replacement call
    # must certify
    assert calls["ok"] >= 1
    assert (fl.val >= 0).sum() == 4

    os.environ["KLT_NO_PREFILTER"] = "1"
    try:
        tr2, fl2 = select_then_lose()
        tr2.replace_lost_features(img, fl2)
    finally:
        os.environ.pop("KLT_NO_PREFILTER")
    np.testing.assert_array_equal(fl.x, fl2.x)
    np.testing.assert_array_equal(fl.val, fl2.val)


def test_device_replace_exhaustion_and_floor():
    """ops.replace: when no candidate reaches max(1, min_eigenvalue)
    after suppression, remaining lost slots must become NOT_FOUND at
    (-1, -1) — the reference's pointlist-exhausted branch
    (src/V1/selectGoodFeatures.c:180-195)."""
    import jax.numpy as jnp
    from klt.config import TrackingConfig, NOT_FOUND
    from klt.ops.replace import replace_lost_features_device

    cfg = TrackingConfig(min_eigenvalue=10 ** 6)  # nothing qualifies
    h, w = 64, 96
    rng = np.random.RandomState(0)
    gx = jnp.asarray(rng.randn(h, w).astype(np.float32))
    gy = jnp.asarray(rng.randn(h, w).astype(np.float32))
    x = jnp.asarray([20.0, 30.0, -1.0, -1.0], jnp.float32)
    y = jnp.asarray([20.0, 30.0, -1.0, -1.0], jnp.float32)
    v = jnp.asarray([0, 0, -1, -2], jnp.int32)
    xn, yn, vn = replace_lost_features_device(gx, gy, x, y, v, cfg)
    xn, yn, vn = np.asarray(xn), np.asarray(yn), np.asarray(vn)
    np.testing.assert_array_equal(vn[:2], [0, 0])  # live slots untouched
    assert (vn[2:] == NOT_FOUND).all()
    assert (xn[2:] == -1).all() and (yn[2:] == -1).all()

    # and with an achievable floor every lost slot refills outside the
    # suppression square of the live features
    cfg2 = TrackingConfig()
    xn, yn, vn = replace_lost_features_device(gx, gy, x, y, v, cfg2)
    xn, yn, vn = np.asarray(xn), np.asarray(yn), np.asarray(vn)
    assert (vn >= 0).all()
    stamp = cfg2.mindist - 1
    for i in (2, 3):
        for j in (0, 1):
            assert max(abs(xn[i] - xn[j]), abs(yn[i] - yn[j])) > stamp
