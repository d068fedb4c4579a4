"""Sharded multi-sequence batch tracking.

B independent image sequences advance one frame-pair per step as a dense
[B, H, W] batch, sharded over the mesh's `data` axis; each sequence's N
features live in [B, N] arrays optionally sharded over `feat`.  Per-
sequence tracking is embarrassingly parallel, so each device runs the
single-device program on its own shard inside `jax.shard_map`: no
collectives on the hot path, and the GPU's LK kernel (a custom call XLA
cannot partition) only ever sees device-local arrays.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import TrackingConfig
from ..ops.pyramid import build_image_pyramids
from ..ops.lk import track_features_pyramid


def make_pair_step(cfg: TrackingConfig):
    """Single-sequence frame-pair tracking step (jit-able, vmap-able).

    step(img1_u8[H,W], img2_u8[H,W], x[N], y[N], val[N])
      -> (x, y, val) after tracking.
    """

    def step(img1, img2, x, y, val):
        pyr1, gx1, gy1 = build_image_pyramids(img1, cfg)
        pyr2, gx2, gy2 = build_image_pyramids(img2, cfg)
        return track_features_pyramid(pyr1, gx1, gy1, pyr2, gx2, gy2,
                                      x, y, val, cfg)

    return step


def make_batch_step(cfg: TrackingConfig, mesh: Mesh | None = None,
                    data_axis: str = "data", feat_axis: str | None = None):
    """Batched step over [B, ...] arrays, jitted with mesh shardings.

    With a mesh, images shard over `data_axis`; feature arrays shard over
    (data_axis, feat_axis).
    """
    from .batched_lk import make_fused_pair_step
    step = make_fused_pair_step(cfg)
    if mesh is None:
        return jax.jit(step)

    img_p = P(data_axis, None, None)
    feat_p = P(data_axis, feat_axis) if feat_axis else P(data_axis, None)
    step = jax.shard_map(step, mesh=mesh,
                         in_specs=(img_p, img_p, feat_p, feat_p, feat_p),
                         out_specs=(feat_p,) * 3, check_vma=False)
    img_s = NamedSharding(mesh, img_p)
    feat_s = NamedSharding(mesh, feat_p)
    return jax.jit(step,
                   in_shardings=(img_s, img_s, feat_s, feat_s, feat_s),
                   out_shardings=(feat_s, feat_s, feat_s))


def track_batch(frames, x, y, val, cfg: TrackingConfig,
                mesh: Mesh | None = None, feat_axis: str | None = None):
    """Track B sequences through T frames.

    frames: uint8 [B, T, H, W]; x, y f32 [B, N]; val i32 [B, N].
    Returns per-frame tables (xs, ys, vals) of shape [T-1, B, N].

    Delegates to the scanned, device-resident
    `parallel.batched_lk.track_sequences_batched` (one dispatch for the
    whole sequence instead of one per frame pair); with a mesh the
    inputs are placed on (data, feat) shardings and every device scans
    its own shard.
    """
    from .batched_lk import track_sequences_batched

    if mesh is None:
        return track_sequences_batched(frames, x, y, val, cfg)
    img_p = P("data", None, None, None)
    feat_p = P("data", feat_axis) if feat_axis else P("data", None)
    table_p = P(None, *feat_p)
    frames = jax.device_put(frames, NamedSharding(mesh, img_p))
    x, y, val = (jax.device_put(a, NamedSharding(mesh, feat_p))
                 for a in (x, y, val))
    return _sharded_sequences(mesh, img_p, feat_p, table_p, cfg)(
        frames, x, y, val)


@functools.lru_cache(maxsize=16)
def _sharded_sequences(mesh: Mesh, img_p, feat_p, table_p,
                       cfg: TrackingConfig):
    """Jitted shard_map of track_sequences_batched, one per layout."""
    from .batched_lk import track_sequences_batched

    return jax.jit(jax.shard_map(
        lambda f, x, y, v: track_sequences_batched(f, x, y, v, cfg),
        mesh=mesh, in_specs=(img_p, feat_p, feat_p, feat_p),
        out_specs=(table_p,) * 3, check_vma=False))


def pad_features_for_mesh(x, y, val, multiple: int):
    """Pad the feature axis to a multiple of the mesh's feat-axis size.

    XLA shardings require even splits; padded lanes carry val=-1 (dead),
    which every tracking op masks out, so results on the first n lanes
    are unchanged.  Returns (x, y, val, n_orig) — slice outputs back
    with [..., :n_orig].
    """
    import numpy as _np
    n = x.shape[-1]
    pad = (-n) % multiple
    if pad == 0:
        return x, y, val, n
    widths = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
    xp = _np.pad(_np.asarray(x), widths, constant_values=0.0)
    yp = _np.pad(_np.asarray(y), widths, constant_values=0.0)
    vp = _np.pad(_np.asarray(val), widths, constant_values=-1)
    return xp, yp, vp, n
