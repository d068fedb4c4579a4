"""Separable convolution / gradients / pyramid vs the CPU oracle."""

import jax.numpy as jnp
import numpy as np

from klt.config import TrackingConfig
from klt.ops.convolve import compute_smoothed_image, compute_gradients
from klt.ops.pyramid import build_pyramid
from conftest import load_f32


def _img0(provided_frames):
    return provided_frames[0].astype(np.float32)


def test_smoothed_image(provided_frames):
    oracle = load_f32("smoothed_img0.f32", (240, 320))
    sm = np.asarray(compute_smoothed_image(jnp.asarray(_img0(provided_frames)),
                                           0.7))
    np.testing.assert_allclose(sm, oracle, atol=2e-3)


def test_gradients(provided_frames):
    sm = load_f32("smoothed_img0.f32", (240, 320))
    gx_o = load_f32("gradx_img0.f32", (240, 320))
    gy_o = load_f32("grady_img0.f32", (240, 320))
    gx, gy = compute_gradients(jnp.asarray(sm), 1.0)
    np.testing.assert_allclose(np.asarray(gx), gx_o, atol=2e-3)
    np.testing.assert_allclose(np.asarray(gy), gy_o, atol=2e-3)


def test_border_zeroing(provided_frames):
    sm = np.asarray(compute_smoothed_image(jnp.asarray(_img0(provided_frames)),
                                           0.7))
    # gauss width for sigma=0.7 is 5 -> radius 2 borders are zero
    assert np.all(sm[:2, :] == 0) and np.all(sm[-2:, :] == 0)
    assert np.all(sm[:, :2] == 0) and np.all(sm[:, -2:] == 0)


def test_pyramid_level1(provided_frames):
    sm = load_f32("smoothed_img0.f32", (240, 320))
    cfg = TrackingConfig()
    assert cfg.subsampling == 4 and cfg.n_pyramid_levels == 2
    pyr = build_pyramid(jnp.asarray(sm), cfg)
    assert pyr[1].shape == (60, 80)
    oracle = load_f32("pyr1_img0.f32", (60, 80))
    np.testing.assert_allclose(np.asarray(pyr[1]), oracle, atol=2e-3)


def test_pyramid_gradients(provided_frames):
    pyr1 = load_f32("pyr1_img0.f32", (60, 80))
    gx_o = load_f32("pyr1_gradx_img0.f32", (60, 80))
    gy_o = load_f32("pyr1_grady_img0.f32", (60, 80))
    gx, gy = compute_gradients(jnp.asarray(pyr1), 1.0)
    np.testing.assert_allclose(np.asarray(gx), gx_o, atol=2e-3)
    np.testing.assert_allclose(np.asarray(gy), gy_o, atol=2e-3)


def test_batched_convolution_matches_single():
    rng = np.random.RandomState(1)
    imgs = rng.rand(3, 24, 40).astype(np.float32)
    batched = np.asarray(compute_smoothed_image(jnp.asarray(imgs), 1.0))
    for b in range(3):
        single = np.asarray(compute_smoothed_image(jnp.asarray(imgs[b]), 1.0))
        # XLA may schedule the batched conv differently -> 1-ulp noise
        np.testing.assert_allclose(batched[b], single, atol=1e-5)
