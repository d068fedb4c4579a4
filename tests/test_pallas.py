"""The LK level kernel (klt/pallas/lk.py) on the CPU.

The kernel runs through the Pallas interpreter (the wrapper's explicit
`interpret` argument) against the per-iteration gather oracle
(ops.lk._track_level_gather) on seeded synthetic level stacks.  The
compiled kernel is checked on the card by chip_smoke.py (phase 1) and by
the `gpu`-marked test below.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from klt.config import TrackingConfig, OOB, TRACKED
from klt.io.synthetic import translated_sequence
from klt.ops.pyramid import build_pyramid_stacks


def _stacks(cfg, seed, gain=1.0, h=120, w=160):
    frames, _ = translated_sequence(2, h, w, seed)
    f2 = np.clip(frames[1] * gain + 6.0 * (gain != 1.0), 0, 255)
    s1 = build_pyramid_stacks(jnp.asarray(frames[0]), cfg)[0]
    s2 = build_pyramid_stacks(jnp.asarray(f2.astype(np.uint8)), cfg)[0]
    return s1, s2


def _lanes(n, h, w, seed):
    """Positions over the whole level and a 4 px band outside it (border
    and OOB lanes), with ~10% inactive lanes."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-4, w + 4, n).astype(np.float32)
    y = rng.uniform(-4, h + 4, n).astype(np.float32)
    act = rng.rand(n) > 0.1
    return jnp.asarray(x), jnp.asarray(y), jnp.asarray(act)


def _oracle(s1, s2, x, y, act, cfg):
    from klt.ops.lk import _track_level_gather
    return jax.jit(_track_level_gather, static_argnums=7)(
        s1, s2, x, y, x, y, act, cfg)


def _assert_matches(out, ref):
    ox, oy, os_, oi = (np.asarray(a) for a in out)
    rx, ry, rs, ri = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(os_, rs)
    np.testing.assert_array_equal(oi, ri)
    np.testing.assert_allclose(ox, rx, atol=1e-3)
    np.testing.assert_allclose(oy, ry, atol=1e-3)


@pytest.mark.parametrize("n", [1, 150, 1000])
@pytest.mark.parametrize("lighting", [False, True])
@pytest.mark.parametrize("ww,wh", [(5, 5), (7, 7), (9, 9), (7, 9)])
def test_kernel_matches_gather_oracle(ww, wh, lighting, n):
    """Kernel vs oracle: statuses and iteration counts equal, positions
    within 1e-3 px (window sums run in another order).  Every case has
    border/OOB lanes and inactive lanes, and F is not a multiple of the
    feature block."""
    from klt.pallas.lk import track_level_lanes
    cfg = TrackingConfig(window_width=ww, window_height=wh,
                         lighting_insensitive=lighting)
    s1, s2 = _stacks(cfg, seed=ww * 10 + wh,
                     gain=1.15 if lighting else 1.0)
    x, y, act = _lanes(n, s1.shape[1], s1.shape[2], seed=n)
    out = track_level_lanes(s1[None], s2[None], x, y, x, y, act,
                            jnp.zeros(n, jnp.int32), cfg=cfg,
                            interpret=True)
    ref = _oracle(s1, s2, x, y, act, cfg)
    _assert_matches(out, ref)
    st = np.asarray(out[2])
    if n >= 150:  # the lane mix really covers every branch
        assert (st == OOB).any() and (st == TRACKED).any()
        assert (np.asarray(act) == 0).any()


def test_kernel_inactive_lanes_pass_through():
    from klt.pallas.lk import track_level_lanes
    cfg = TrackingConfig()
    s1, s2 = _stacks(cfg, seed=5)
    x, y, _ = _lanes(40, s1.shape[1], s1.shape[2], seed=2)
    act = jnp.zeros(40, bool)
    out = track_level_lanes(s1[None], s2[None], x, y, x + 1.0, y - 1.0,
                            act, jnp.zeros(40, jnp.int32), cfg=cfg,
                            interpret=True)
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(x + 1.0))
    np.testing.assert_array_equal(np.asarray(out[1]), np.asarray(y - 1.0))
    assert (np.asarray(out[2]) == TRACKED).all()
    assert (np.asarray(out[3]) == 0).all()


def test_kernel_sequence_index_matches_per_sequence_calls():
    """One launch over lanes of S sequences (per-lane sequence index into
    [S, 3, H, W]) equals S single-sequence launches, bit for bit."""
    from klt.pallas.lk import track_level_lanes
    cfg = TrackingConfig()
    pairs = [_stacks(cfg, seed=s) for s in (11, 12, 13)]
    st1 = jnp.stack([p[0] for p in pairs])
    st2 = jnp.stack([p[1] for p in pairs])
    n = 70
    lanes = [_lanes(n, st1.shape[2], st1.shape[3], seed=s)
             for s in range(3)]
    cat = [jnp.concatenate([ln[k] for ln in lanes]) for k in range(3)]
    seq = jnp.repeat(jnp.arange(3, dtype=jnp.int32), n)
    out = track_level_lanes(st1, st2, cat[0], cat[1], cat[0], cat[1],
                            cat[2], seq, cfg=cfg, interpret=True)
    for s, (x, y, act) in enumerate(lanes):
        one = track_level_lanes(st1[s][None], st2[s][None], x, y, x, y,
                                act, jnp.zeros(n, jnp.int32), cfg=cfg,
                                interpret=True)
        for a, b in zip(out, one):
            np.testing.assert_array_equal(np.asarray(a)[s * n:(s + 1) * n],
                                          np.asarray(b))


@pytest.mark.parametrize("ww,wh,fb", [(7, 7, 32), (9, 9, 8), (7, 9, 16),
                                      (3, 3, 128)])
def test_feature_block_follows_window(ww, wh, fb):
    from klt.pallas.lk import feature_block
    assert feature_block(TrackingConfig(window_width=ww,
                                        window_height=wh)) == fb


def test_dispatch_takes_plain_path_on_cpu(monkeypatch):
    """On the CPU the level drivers never call the kernel; with the
    kernel enabled, the single and batched drivers route every level
    through it (the batched one with per-lane sequence indices)."""
    import klt.ops.lk as LK
    import klt.parallel.batched_lk as BL
    from klt import pallas
    assert not pallas.lk_kernel_enabled()

    def boom(*a, **k):
        raise AssertionError("kernel called on the CPU")

    monkeypatch.setattr(LK, "track_level_lanes", boom)
    monkeypatch.setattr(BL, "track_level_lanes", boom)
    cfg = TrackingConfig()
    s1, s2 = _stacks(cfg, seed=3)
    x, y, act = _lanes(20, s1.shape[1], s1.shape[2], seed=1)
    LK.track_level(s1, s2, x, y, x, y, act, cfg)
    BL.track_level_batched(s1[None], s2[None], x[None], y[None],
                           x[None], y[None], act[None], cfg)

    calls = []

    def spy(st1, st2, x1, y1, x2, y2, active, seq, cfg):
        calls.append((st1.shape, x1.shape, np.asarray(seq)))
        z = jnp.zeros(x1.shape, jnp.int32)
        return x2, y2, z, z

    monkeypatch.setattr(LK, "lk_kernel_enabled", lambda: True)
    monkeypatch.setattr(BL, "lk_kernel_enabled", lambda: True)
    monkeypatch.setattr(LK, "track_level_lanes", spy)
    monkeypatch.setattr(BL, "track_level_lanes", spy)
    LK.track_level(s1, s2, x, y, x, y, act, cfg)
    assert calls[-1][0] == (1,) + s1.shape and calls[-1][1] == (20,)
    b2 = jnp.stack([s1, s1])
    BL.track_level_batched(b2, b2, jnp.stack([x, x]), jnp.stack([y, y]),
                           jnp.stack([x, x]), jnp.stack([y, y]),
                           jnp.stack([act, act]), cfg)
    assert calls[-1][0] == b2.shape and calls[-1][1] == (40,)
    np.testing.assert_array_equal(calls[-1][2], np.repeat([0, 1], 20))


@pytest.mark.gpu
def test_kernel_compiled_on_gpu_matches_gather(gpu_device):
    """The compiled (not interpreted) kernel against the oracle."""
    from klt.pallas.lk import track_level_lanes
    cfg = TrackingConfig()
    with jax.default_device(gpu_device):
        s1, s2 = _stacks(cfg, seed=9, h=240, w=320)
        x, y, act = _lanes(1000, 240, 320, seed=4)
        out = track_level_lanes(s1[None], s2[None], x, y, x, y, act,
                                jnp.zeros(1000, jnp.int32), cfg=cfg)
        ref = _oracle(s1, s2, x, y, act, cfg)
    _assert_matches(out, ref)
