"""Gaussian pyramid construction.

Reference semantics (_KLTComputePyramid, src/V1/pyramid.c:87-131): level 0
is the (pre-smoothed) input; each coarser level smooths the previous level
with sigma = subsampling * pyramid_sigma_fact and decimates with stride
`subsampling` at offset `subsampling // 2`.  Level dims shrink by integer
division.  All levels stay device-resident, as in the V3 GPU-resident
pyramid chain (src/V3/pyramidGPU.cu:186-235).  XLA fuses the separable
passes, and decimation is a strided slice.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import TrackingConfig, pyramid_shapes
from .convolve import (compute_smoothed_image, compute_gradients,
                       level_gradients_and_smooth)


def build_pyramid(img: jax.Array, cfg: TrackingConfig) -> list[jax.Array]:
    """List of per-level float32 images, finest first."""
    s = cfg.subsampling
    sh = s // 2
    shapes = pyramid_shapes(img.shape[-1], img.shape[-2], cfg)
    levels = [img]
    for lvl in range(1, cfg.n_pyramid_levels):
        prev = levels[-1]
        sm = compute_smoothed_image(prev, cfg.pyramid_sigma)
        ncols, nrows = shapes[lvl]
        levels.append(sm[..., sh::s, sh::s][..., :nrows, :ncols])
    return levels


def build_image_pyramids(img: jax.Array, cfg: TrackingConfig):
    """(pyr, pyr_gradx, pyr_grady) from a raw uint8/float frame.

    Applies the pre-smoothing step the tracker uses
    (reference: src/V1/trackFeatures.c:1296-1308) and computes per-level
    gradients with grad_sigma.
    """
    smoothed = compute_smoothed_image(img.astype(jnp.float32),
                                      cfg.smooth_sigma)
    s = cfg.subsampling
    sh = s // 2
    shapes = pyramid_shapes(img.shape[-1], img.shape[-2], cfg)

    pyr, gradx, grady = [smoothed], [], []
    for lvl in range(cfg.n_pyramid_levels):
        last = lvl == cfg.n_pyramid_levels - 1
        gx, gy, sm = level_gradients_and_smooth(pyr[lvl], cfg,
                                                with_pyramid_smooth=not last)
        gradx.append(gx)
        grady.append(gy)
        if not last:
            ncols, nrows = shapes[lvl + 1]
            pyr.append(sm[..., sh::s, sh::s][..., :nrows, :ncols])
    return pyr, gradx, grady


def build_pyramid_stacks(img: jax.Array, cfg: TrackingConfig):
    """Finest-first [3, H_l, W_l] (intensity, gradx, grady) stacks,
    the layout the LK level driver consumes directly."""
    pyr, gx, gy = build_image_pyramids(img, cfg)
    return [jnp.stack([p, a, b]) for p, a, b in zip(pyr, gx, gy)]


def build_pyramid_stacks_batched(imgs: jax.Array, cfg: TrackingConfig):
    """[B, H, W] frames -> finest-first list of [B, 3, H_l, W_l]
    stacks."""
    sts = jax.vmap(lambda im: tuple(build_pyramid_stacks(im, cfg)))(imgs)
    return list(sts)
