"""Batched bilinear interpolation / window sampling.

The reference interpolates one scalar at a time (_interpolate,
src/V1/trackFeatures.c:31-57, 23% of CPU time at 2M calls).  Here all N
features sample their whole window in one vectorized gather: coordinates
are truncated toward zero (C `(int)` cast — coordinates are guaranteed
non-negative by the tracker's bounds checks), the four neighbors are
gathered, and the bilinear blend runs elementwise.

Boundary semantics: the CPU reference *asserts* in-bounds; the three GPU
versions disagree (clamp / return 0).  We adopt clamped indexing, which is
exact for every in-bounds access and merely keeps masked-out (dead) lanes
finite — the batched analogue of the CPU assert contract.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def window_offsets(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """Integer window offsets (dx, dy), row-major like the reference's
    `for j ... for i ...` window walks — each [height*width]."""
    hw, hh = width // 2, height // 2
    dy, dx = np.mgrid[-hh:hh + 1, -hw:hw + 1]
    return dx.ravel().astype(np.float32), dy.ravel().astype(np.float32)


def bilinear_sample(img: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Sample img[y, x] bilinearly for arbitrary-shaped coordinate arrays.

    img: [H, W] float32; x, y: f32 arrays (same shape); returns same shape.
    """
    h, w = img.shape[-2], img.shape[-1]
    xt = x.astype(jnp.int32)  # trunc toward zero; in-bounds coords are >= 0
    yt = y.astype(jnp.int32)
    ax = x - xt.astype(jnp.float32)
    ay = y - yt.astype(jnp.float32)

    x0 = jnp.clip(xt, 0, w - 2)
    y0 = jnp.clip(yt, 0, h - 2)

    p00 = img[..., y0, x0]
    p01 = img[..., y0, x0 + 1]
    p10 = img[..., y0 + 1, x0]
    p11 = img[..., y0 + 1, x0 + 1]

    return ((1 - ax) * (1 - ay) * p00 + ax * (1 - ay) * p01 +
            (1 - ax) * ay * p10 + ax * ay * p11)


def sample_stack_windows(stack: jax.Array, x: jax.Array, y: jax.Array,
                         width: int, height: int) -> jax.Array:
    """Bilinear (width x height) windows around each center, for C images
    at once, via per-feature patch slicing.

    stack: [C, H, W] f32; x, y: [N] window centers.
    Returns [C, N, height*width] samples at (x+i, y+j) for the row-major
    integer window offsets.

    Instead of 4*K element gathers per feature (the batched
    transliteration of the reference's per-pixel _interpolate), each
    feature slices ONE integer-aligned (height+1, width+1) patch (a
    single gather of contiguous blocks) and the bilinear blend runs as
    four shifted multiplies.  The fractional weights are
    constant across a window because the offsets are integers.
    """
    c = stack.shape[0]
    h_img, w_img = stack.shape[-2], stack.shape[-1]
    hw, hh = width // 2, height // 2
    xt = x.astype(jnp.int32)
    yt = y.astype(jnp.int32)
    ax = (x - xt.astype(jnp.float32))[:, None, None, None]
    ay = (y - yt.astype(jnp.float32))[:, None, None, None]

    def one(ys, xs):
        # dynamic_slice clamps out-of-range starts, which only masked-out
        # (dead) lanes can produce.
        return jax.lax.dynamic_slice(stack, (0, ys, xs),
                                     (c, height + 1, width + 1))

    p = jax.vmap(one)(yt - hh, xt - hw)  # [N, C, height+1, width+1]
    p00 = p[:, :, :-1, :-1]
    p01 = p[:, :, :-1, 1:]
    p10 = p[:, :, 1:, :-1]
    p11 = p[:, :, 1:, 1:]
    out = ((1 - ax) * (1 - ay) * p00 + ax * (1 - ay) * p01 +
           (1 - ax) * ay * p10 + ax * ay * p11)  # [N, C, h, w]
    n = x.shape[0]
    return out.transpose(1, 0, 2, 3).reshape(c, n, height * width)


def onehot_extract(stack: jax.Array, y0: jax.Array, x0: jax.Array,
                   ny: int, nx: int, chunk: int = 512) -> jax.Array:
    """Integer-aligned patch extraction via one-hot matmuls.

    stack: [C, H, W]; y0, x0: int32 [F] top-left corners (assumed
    in-bounds / pre-clipped).  Returns [F, C, ny, nx].

    A dense one-hot row-selection matmul plus a batched column-selection
    einsum.  HIGHEST precision makes the 0/1-weighted selection exact.
    Large feature counts are chunked to bound the one-hot
    materialization.
    """
    f = y0.shape[0]
    c, h_img, w_img = stack.shape
    hi = jnp.arange(h_img, dtype=jnp.int32)
    wi = jnp.arange(w_img, dtype=jnp.int32)

    def extract_chunk(y0c, x0c):
        fc = y0c.shape[0]
        rows = (y0c[:, None] +
                jnp.arange(ny, dtype=jnp.int32)[None, :]).reshape(-1)
        row_oh = (rows[:, None] == hi[None, :]).astype(jnp.float32)
        band = jnp.einsum("rh,chw->crw", row_oh, stack,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
        band = band.reshape(c, fc, ny, w_img)
        col_oh = ((x0c[:, None, None] +
                   jnp.arange(nx, dtype=jnp.int32)[None, :, None]) ==
                  wi[None, None, :]).astype(jnp.float32)  # [fc, nx, W]
        out = jnp.einsum("cfrw,fxw->fcrx", band, col_oh,
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
        return out

    if f <= chunk:
        return extract_chunk(y0, x0)
    pad = (-f) % chunk
    y0p = jnp.pad(y0, (0, pad))
    x0p = jnp.pad(x0, (0, pad))
    n_chunks = (f + pad) // chunk
    outs = jax.lax.map(lambda args: extract_chunk(*args),
                       (y0p.reshape(n_chunks, chunk),
                        x0p.reshape(n_chunks, chunk)))
    return outs.reshape(n_chunks * chunk, c, ny, nx)[:f]


_ROW_BLOCK = 8  # aligned row-block size for the blocked extraction
_ROWS_MIN_F = 512  # feature count from which exact-row selection is used


def pack_stack_channels(stack: jax.Array) -> jax.Array:
    """[C, H, W] -> channel-block lane packing [H, C*W].

    One relayout per level per frame, amortized over every extraction
    round that reads it (extract_packed_cb)."""
    c, h, w = stack.shape
    return stack.transpose(1, 0, 2).reshape(h, c * w)


def extract_packed_cb(stack_packed: jax.Array, y0: jax.Array,
                      x0: jax.Array, ny: int, nx: int,
                      c: int = 3) -> jax.Array:
    """Patch extraction from a channel-packed image into the channel-
    block layout [F, ny, C*nx] the affine stage keeps its patches in.

    stack_packed: [H, C*W] (pack_stack_channels).  Row-block-aligned
    one-hot selection over H/8 blocks, then ONE batched dot against a
    per-feature block-diagonal column one-hot [C*W, C*nx], then a
    binary row re-alignment (masked static slices).  The one-hot
    matmuls run at HIGHEST, which keeps the 0/1-weighted selection of
    f32 image data exact; below it the GPU rounds the data to TF32.
    """
    prec, band_dt = jax.lax.Precision.HIGHEST, jnp.float32
    h, cw = stack_packed.shape
    w_img = cw // c
    f = y0.shape[0]
    # block-diagonal column one-hot: lane j of the output reads lane
    # (j // nx) * W + x0 + (j % nx) of the packed row
    j = jnp.arange(c * nx, dtype=jnp.int32)
    target = (j // nx) * w_img + (j % nx)                 # [C*nx]
    wp = jnp.arange(cw, dtype=jnp.int32)
    col_oh = ((x0[:, None, None] + target[None, None, :]) ==
              wp[None, :, None]).astype(jnp.float32)      # [F, C*W, C*nx]
    if f >= _ROWS_MIN_F:
        # exact-row band: no 8-row blocks, no realign (at large F the
        # blocked band and the 3-step realign dominate as relayout
        # traffic)
        rows = (y0[:, None] +
                jnp.arange(ny, dtype=jnp.int32)[None, :]).reshape(-1)
        hi = jnp.arange(h, dtype=jnp.int32)
        row_oh = (rows[:, None] == hi[None, :]).astype(jnp.float32)
        band = jnp.dot(row_oh, stack_packed, precision=prec,
                       preferred_element_type=band_dt)
        band = band.reshape(f, ny, cw)
        return jnp.einsum("frw,fwj->frj", band, col_oh, precision=prec,
                          preferred_element_type=jnp.float32)
    band, rem = _band_select(stack_packed, y0, ny,
                             mm=(prec, band_dt))
    sel = jnp.einsum("frw,fwj->frj", band, col_oh, precision=prec,
                     preferred_element_type=jnp.float32)  # [F, 24, C*nx]
    return _realign_rows(sel, rem, ny)


def _band_select(stack_packed: jax.Array, y0: jax.Array, ny: int, mm):
    """Row-block-aligned band selection: returns
    (band [F, nblk*8, C*W], rem [F]); mm is the (precision, band
    dtype) pair."""
    prec, band_dt = mm
    h, cw = stack_packed.shape
    b = _ROW_BLOCK
    hp = (-h) % b
    if hp:
        stack_packed = jnp.pad(stack_packed, ((0, hp), (0, 0)))
    nb_img = (h + hp) // b
    # rows rem..rem+ny-1 with rem in [0, b): the last touched row is at
    # most ny + b - 2, needing (ny+b-2)//b + 1 aligned blocks.  (The
    # round-1 formula ny//b + 1 under-counted for ny < b — caught by
    # the window-geometry fuzz test.)
    nblk = (ny + b - 2) // b + 1
    f = y0.shape[0]
    b0 = y0 // b
    rem = y0 - b0 * b
    blocks = (b0[:, None] +
              jnp.arange(nblk, dtype=jnp.int32)[None, :]).reshape(-1)
    blocks = jnp.clip(blocks, 0, nb_img - 1)
    blk_oh = (blocks[:, None] ==
              jnp.arange(nb_img, dtype=jnp.int32)[None, :]
              ).astype(jnp.float32)
    st4 = stack_packed.reshape(nb_img, b * cw)
    band = jnp.einsum("bh,hw->bw", blk_oh, st4, precision=prec,
                      preferred_element_type=band_dt)
    return band.reshape(f, nblk * b, cw), rem


def _realign_rows(sel: jax.Array, rem: jax.Array, ny: int):
    """Binary row re-alignment by rem in [0, 8)."""
    out = sel
    shift = 1
    while shift < _ROW_BLOCK:
        bit = ((rem & shift) != 0)[:, None, None]
        keep = out.shape[1] - shift
        out = jnp.where(bit, out[:, shift:shift + keep, :],
                        out[:, :keep, :])
        shift *= 2
    return out[:, :ny, :]


def select_windows_bilinear(patches: jax.Array, oy: jax.Array,
                            ox: jax.Array, ay: jax.Array, ax: jax.Array,
                            height: int, width: int) -> jax.Array:
    """Bilinear (height x width) window selection inside resident patches.

    patches: [F, C, Sy, Sx]; oy, ox int32 [F] integer window corners in
    patch coordinates (pre-clipped to [0, S-height-1]); ay, ax fractional
    parts.  Returns [C, F, height*width].

    W = Rb @ P @ Cb^T with Rb/Cb carrying the (1-a, a) bilinear weights:
    batched matmuls at HIGHEST, no gathers.  Equals the reference's 4-term
    bilinear blend (src/V1/trackFeatures.c:53-56) up to ~1 ulp.
    """
    f, c, sy, sx = patches.shape
    sy_i = jnp.arange(sy, dtype=jnp.int32)
    sx_i = jnp.arange(sx, dtype=jnp.int32)

    rr = oy[:, None, None] + jnp.arange(height,
                                        dtype=jnp.int32)[None, :, None]
    rb = ((sy_i[None, None, :] == rr) * (1 - ay)[:, None, None] +
          (sy_i[None, None, :] == rr + 1) * ay[:, None, None])
    cc = ox[:, None, None] + jnp.arange(width,
                                        dtype=jnp.int32)[None, :, None]
    cb = ((sx_i[None, None, :] == cc) * (1 - ax)[:, None, None] +
          (sx_i[None, None, :] == cc + 1) * ax[:, None, None])

    a = jnp.einsum("fhs,fcst->fcht", rb.astype(jnp.float32), patches,
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)
    w = jnp.einsum("fcht,fwt->fchw", a, cb.astype(jnp.float32),
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)
    return w.reshape(f, c, height * width).transpose(1, 0, 2)


def sample_windows(img: jax.Array, x: jax.Array, y: jax.Array,
                   dx: jax.Array, dy: jax.Array) -> jax.Array:
    """Window samples around each feature center.

    img [H,W]; x,y [N]; dx,dy [K] -> [N,K] bilinear samples at
    (x+dx, y+dy), the batched form of the reference's per-feature window
    walks (src/V1/trackFeatures.c:68-123).
    """
    xs = x[:, None] + dx[None, :]
    ys = y[:, None] + dy[None, :]
    return bilinear_sample(img, xs, ys)
