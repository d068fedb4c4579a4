"""Separable convolution ops (smoothing + gradients), XLA path.

Design notes
------------
The reference walks each row/column with a scalar accumulator
(src/V1/convolve.c:137-242).  Here each pass is a single
`lax.conv_general_dilated` over the whole image, with the border masking
fused by XLA.  Semantics preserved from the
reference:

* taps are applied in reversed order (true convolution, not correlation) —
  the reference's inner loop walks taps from width-1 down to 0
  (src/V1/convolve.c:171-172);
* output borders within `radius` of the edge are ZEROED, not clamped or
  zero-padded (src/V1/convolve.c:163-178, :215-237) — and the vertical pass
  consumes the horizontally-zeroed intermediate, exactly like the C code;
* all accumulation stays in float32 (sub-pixel tolerance contract).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def to_float_image(img: jax.Array) -> jax.Array:
    """uint8 frame -> float32 image (reference: src/V1/convolve.c:37-53)."""
    return img.astype(jnp.float32)


def _col_mask(ncols: int, radius: int) -> np.ndarray:
    m = np.ones((1, ncols), dtype=np.float32)
    if radius > 0:
        m[:, :radius] = 0.0
        m[:, ncols - radius:] = 0.0
    return m


def _row_mask(nrows: int, radius: int) -> np.ndarray:
    m = np.ones((nrows, 1), dtype=np.float32)
    if radius > 0:
        m[:radius, :] = 0.0
        m[nrows - radius:, :] = 0.0
    return m


def _conv1d(img: jax.Array, taps: np.ndarray, axis: int) -> jax.Array:
    """Single-axis convolution of a [..., H, W] image with reversed taps."""
    width = len(taps)
    radius = width // 2
    rev = jnp.asarray(np.ascontiguousarray(taps[::-1]), dtype=jnp.float32)
    if axis == 1:  # horizontal
        rhs = rev.reshape(1, 1, 1, width)
        pad = [(0, 0), (radius, radius)]
    else:  # vertical
        rhs = rev.reshape(1, 1, width, 1)
        pad = [(radius, radius), (0, 0)]
    lead = img.shape[:-2]
    h, w = img.shape[-2], img.shape[-1]
    lhs = img.reshape((-1, 1, h, w))
    # HIGHEST precision keeps the multiplies in true f32; a lower one
    # may round operands (TF32 on the GPU), blowing the sub-pixel
    # accuracy contract.
    out = lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1), padding=pad,
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST)
    return out.reshape(lead + (h, w))


def convolve_separable(img: jax.Array, horiz_taps: np.ndarray,
                       vert_taps: np.ndarray) -> jax.Array:
    """Horizontal pass then vertical pass with zeroed borders.

    Matches _convolveSeparate (src/V1/convolve.c:249-266): the vertical
    pass reads the horizontally-convolved (and border-zeroed) intermediate.
    """
    h, w = img.shape[-2], img.shape[-1]
    hr = len(horiz_taps) // 2
    vr = len(vert_taps) // 2

    tmp = _conv1d(img, horiz_taps, axis=1)
    tmp = tmp * jnp.asarray(_col_mask(w, hr))
    out = _conv1d(tmp, vert_taps, axis=0)
    out = out * jnp.asarray(_row_mask(h, vr))
    return out


def _conv1d_multi(img: jax.Array, taps_list: list[np.ndarray],
                  axis: int) -> jax.Array:
    """One H or V pass producing/consuming multiple channels in a single
    conv op.

    axis=1 (horizontal): img [H, W] -> [C, H, W], one output channel per
    taps entry.  axis=0 (vertical): img [C, H, W] -> [C, H, W], channel i
    convolved with taps_list[i] (grouped conv).  Kernels are zero-padded
    to a common width — padding taps are zero so interior values are
    bit-identical to separate passes; border zeroing still uses each
    kernel's own radius.
    """
    width = max(len(t) for t in taps_list)
    if width % 2 == 0:
        width += 1
    c = len(taps_list)
    padded = np.zeros((c, width), np.float32)
    for i, t in enumerate(taps_list):
        off = (width - len(t)) // 2
        padded[i, off:off + len(t)] = t[::-1]
    radius = width // 2

    if axis == 1:
        h, w = img.shape[-2], img.shape[-1]
        lhs = img.reshape(1, 1, h, w)
        rhs = jnp.asarray(padded).reshape(c, 1, 1, width)
        out = lax.conv_general_dilated(
            lhs, rhs, (1, 1), [(0, 0), (radius, radius)],
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST)
        out = out.reshape(c, h, w)
    else:
        h, w = img.shape[-2], img.shape[-1]
        lhs = img.reshape(1, c, h, w)
        rhs = jnp.asarray(padded).reshape(c, 1, width, 1)
        out = lax.conv_general_dilated(
            lhs, rhs, (1, 1), [(radius, radius), (0, 0)],
            feature_group_count=c,
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST)
        out = out.reshape(c, h, w)

    # per-channel border zeroing with each kernel's own radius
    masks = []
    for t in taps_list:
        r = len(t) // 2
        masks.append(_col_mask(img.shape[-1], r) if axis == 1
                     else _row_mask(img.shape[-2], r))
    mask = jnp.asarray(np.stack(masks))
    return out * mask


def level_gradients_and_smooth(img: jax.Array, cfg,
                               with_pyramid_smooth: bool):
    """Fused per-level op: gradients (+ optionally the next level's
    pre-subsample smoothing) in two conv passes instead of six.

    Matches _KLTComputeGradients + _KLTComputeSmoothedImage semantics
    (src/V1/convolve.c:273-314) bit-for-bit on the interior; the shared
    pass zero-pads narrower kernels (padding taps contribute nothing).
    """
    from ..kernels import gaussian_kernels
    gauss, deriv = gaussian_kernels(cfg.grad_sigma)
    h_taps = [deriv, gauss]
    v_taps = [gauss, deriv]
    if with_pyramid_smooth:
        gauss_p, _ = gaussian_kernels(cfg.pyramid_sigma)
        h_taps.append(gauss_p)
        v_taps.append(gauss_p)
    tmp = _conv1d_multi(img, h_taps, axis=1)
    out = _conv1d_multi(tmp, v_taps, axis=0)
    gradx, grady = out[0], out[1]
    smooth_next = out[2] if with_pyramid_smooth else None
    return gradx, grady, smooth_next


def compute_smoothed_image(img: jax.Array, sigma: float) -> jax.Array:
    """Gaussian smooth (reference: _KLTComputeSmoothedImage,
    src/V1/convolve.c:300-314)."""
    from ..kernels import gaussian_kernels
    gauss, _ = gaussian_kernels(sigma)
    return convolve_separable(img, gauss, gauss)


def compute_gradients(img: jax.Array, sigma: float) -> tuple[jax.Array,
                                                             jax.Array]:
    """(gradx, grady) via derivative-of-Gaussian (reference:
    _KLTComputeGradients, src/V1/convolve.c:273-293)."""
    from ..kernels import gaussian_kernels
    gauss, deriv = gaussian_kernels(sigma)
    gradx = convolve_separable(img, deriv, gauss)
    grady = convolve_separable(img, gauss, deriv)
    return gradx, grady
