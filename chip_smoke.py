#!/usr/bin/env python3
"""Run the tracker's main path once on an NVIDIA GPU and check every result.

    python chip_smoke.py               # phases 0-6 on one card
    python chip_smoke.py --devices 4   # the four-card phase, and no other

Frames come from the seeded generator in klt/io/synthetic.py, so every
feature's true motion is known.  Phases, each at the widths of the
repo's cells, each printing one result line with the card's name and
power limit:

  0  device: the first JAX device must be a GPU; nothing runs on the CPU
  1  LK level kernel (pallas/lk.py) against the plain gather reference
     (ops.lk._track_level_gather) on the same level stacks and starts:
     320x240/150 features/2 levels and 640x480/2000 features/4 levels
  2  flagship single stream: select_good_features + track_sequence,
     320x240, 10 frames, 150 features; against the true motion and the
     plain reference, and KLTracker.track_features on the same frames
  3  batched: track_sequences_batched, B=16 of phase 2's shape; every
     lane against its single-stream result
  4  replacement: track_sequence_replace, 640x480, 64 frames, 500
     features; then track_sequence_replace_exact on a short run, the GPU
     result against the same tier on the CPU device: statuses and picks
     exactly, positions within 1e-3 px (the fraction that is bit-equal
     is printed)
  5  affine: track_sequence_affine, 640x480, 32 frames, 2000 features,
     4 levels, subsampling 2; against the same run under HIGHEST
     default matmul precision
  6  bundle adjustment: a few bundle_adjust_cg iterations on phase 4's
     tracks; the cost must decrease

Any failed check raises and the script exits non-zero.  The last line of
standard output is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import klt  # noqa: E402
from klt.config import TrackingConfig, TRACKED  # noqa: E402
from klt.io.synthetic import translated_sequence  # noqa: E402
from klt.ops.lk import _track_level_gather, coarse_to_fine  # noqa: E402
from klt.ops.pyramid import build_pyramid_stacks  # noqa: E402
from klt.pallas.lk import track_level_lanes  # noqa: E402

FLAGSHIP = dict(height=240, width=320, n_frames=10, n_features=150)
BATCH = 16
REPLACE = dict(height=480, width=640, n_frames=64, n_features=500,
               exact_frames=8)
AFFINE = dict(height=480, width=640, n_frames=32, n_features=2000)
BA_ITERATIONS = 5
GT_MEDIAN_PX = 0.05      # median per-step error against the true motion
DRIFT_PX = 1e-3          # kernel vs plain reference on co-tracked lanes
MIN_STATUS_AGREEMENT = 0.999


class SmokeFailure(RuntimeError):
    """A phase's check did not hold."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    """The cards' name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def flagship_cfg() -> TrackingConfig:
    return TrackingConfig(sequential_mode=True)


def affine_cfg() -> TrackingConfig:
    return TrackingConfig(sequential_mode=True, affine_consistency_check=2,
                          n_pyramid_levels=4, subsampling=2)


def select(frame, n_features, cfg):
    """Host selection on frame -> (x, y, val) numpy arrays."""
    fl = klt.FeatureList.create(n_features)
    klt.KLTracker(cfg).select_good_features(frame, fl)
    return fl.x.copy(), fl.y.copy(), fl.val.copy()


def step_errors(x0, y0, v0, xs, ys, vs, motion):
    """Per-step displacement error against the true motion, over lanes
    tracked (val == 0) from a live position in the previous frame."""
    X = np.concatenate([x0[None], np.asarray(xs)])
    Y = np.concatenate([y0[None], np.asarray(ys)])
    V = np.concatenate([v0[None], np.asarray(vs)])
    ok = (V[1:] == TRACKED) & (V[:-1] >= 0)
    dm = np.diff(motion[:X.shape[0]], axis=0)
    err = np.hypot(np.diff(X, axis=0) - dm[:, :1],
                   np.diff(Y, axis=0) - dm[:, 1:])
    return err[ok]


def compare_tracks(a, b):
    """(status agreement, max drift on lanes TRACKED in both, lanes that
    differ in status) between two (x, y, val) results."""
    ax, ay, av = (np.asarray(t) for t in a)
    bx, by, bv = (np.asarray(t) for t in b)
    agree = float((av == bv).mean())
    both = (av >= 0) & (bv >= 0)
    drift = float(np.max(np.hypot(ax - bx, ay - by)[both], initial=0.0))
    return agree, drift, np.argwhere(av != bv)


@functools.partial(jax.jit, static_argnums=(5,))
def _reference_pair(st1, st2, x, y, val, cfg: TrackingConfig):
    nr0, nc0 = st1[0].shape[-2], st1[0].shape[-1]
    return coarse_to_fine(_track_level_gather, st1, st2, x, y, val, cfg,
                          nr0, nc0)


_stacks = jax.jit(lambda f, cfg: build_pyramid_stacks(f, cfg),
                  static_argnums=1)


def reference_sequence(frames, x, y, val, cfg):
    """The plain reference: frame pairs through the per-iteration gather
    oracle (ops.lk._track_level_gather), one step at a time."""
    xs, ys, vs = [], [], []
    st1 = _stacks(jnp.asarray(frames[0]), cfg)
    xc, yc, vc = jnp.asarray(x), jnp.asarray(y), jnp.asarray(val)
    for t in range(1, len(frames)):
        st2 = _stacks(jnp.asarray(frames[t]), cfg)
        xc, yc, vc = _reference_pair(st1, st2, xc, yc, vc, cfg)
        xs.append(xc), ys.append(yc), vs.append(vc)
        st1 = st2
    return np.stack(xs), np.stack(ys), np.stack(vs)


# --------------------------------------------------------------------- #
# phases                                                                #
# --------------------------------------------------------------------- #

def phase_lk_kernel(height, width, n_features, cfg, seed=1,
                    interpret=False):
    """LK kernel vs the gather reference, level by level, on the same
    stacks and starts.  Returns a dict of per-level results."""
    frames, _ = translated_sequence(2, height, width, seed)
    st1 = _stacks(jnp.asarray(frames[0]), cfg)
    st2 = _stacks(jnp.asarray(frames[1]), cfg)
    x, y, val = select(frames[0], n_features, cfg)
    active = jnp.asarray(val >= 0)
    out = {}
    for r in range(cfg.n_pyramid_levels):
        s = np.float32(cfg.subsampling) ** r
        x1 = jnp.asarray(x / s)
        y1 = jnp.asarray(y / s)
        seq = jnp.zeros(x1.shape, jnp.int32)
        args = (st1[r][None], st2[r][None], x1, y1, x1, y1, active, seq)
        compiled = track_level_lanes.lower(
            *args, cfg=cfg, interpret=interpret).compile()
        mem = compiled.memory_analysis()
        kern = jax.block_until_ready(compiled(*args))
        ref = jax.jit(_track_level_gather, static_argnums=7)(
            st1[r], st2[r], x1, y1, x1, y1, active, cfg)
        agree, drift, bad = compare_tracks(kern[:3], ref[:3])
        for i in bad[:, 0]:
            print(f"  level {r} lane {i}: kernel status "
                  f"{int(kern[2][i])} at ({float(kern[0][i]):.4f}, "
                  f"{float(kern[1][i]):.4f}), reference "
                  f"{int(ref[2][i])} at ({float(ref[0][i]):.4f}, "
                  f"{float(ref[1][i]):.4f})")
        check(agree >= MIN_STATUS_AGREEMENT,
              f"level {r}: status agreement {agree}")
        check(drift <= DRIFT_PX, f"level {r}: drift {drift} px")
        out[r] = dict(shape=tuple(st1[r].shape), status_agreement=agree,
                      drift_px=drift,
                      temp_bytes=getattr(mem, "temp_size_in_bytes", None),
                      argument_bytes=getattr(
                          mem, "argument_size_in_bytes", None))
    return out


def phase_single_stream(height, width, n_frames, n_features, seed=2):
    """track_sequence on the flagship shape: true motion + reference."""
    from klt.runtime.pipeline import track_sequence
    cfg = flagship_cfg()
    frames, motion = translated_sequence(n_frames, height, width, seed)
    x, y, val = select(frames[0], n_features, cfg)
    args = (jnp.asarray(frames), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(val), cfg)
    out, first_s = timed(track_sequence, *args)
    _, warm_s = timed(track_sequence, *args)
    err = step_errors(x, y, val, *out, motion)
    check(err.size > 0, "no feature was tracked")
    med = float(np.median(err))
    check(med <= GT_MEDIAN_PX, f"median error {med} px vs true motion")
    ref = reference_sequence(frames, x, y, val, cfg)
    agree, drift, _ = compare_tracks(out, ref)
    check(agree >= 0.99, f"status agreement with reference {agree}")
    check(drift <= DRIFT_PX, f"drift vs reference {drift} px")
    # the per-pair API (KLTracker.track_features) on the same frames
    fl = klt.FeatureList.create(n_features)
    fl.x[:], fl.y[:], fl.val[:] = x, y, val
    tracker = klt.KLTracker(cfg)
    for t in range(1, n_frames):
        tracker.track_features(frames[t - 1], frames[t], fl)
    last = tuple(np.asarray(o)[-1] for o in out)
    api_agree, api_drift, _ = compare_tracks((fl.x, fl.y, fl.val), last)
    check(api_agree >= MIN_STATUS_AGREEMENT and api_drift <= DRIFT_PX,
          f"track_features vs track_sequence: agreement {api_agree}, "
          f"drift {api_drift} px")
    return dict(fps=(n_frames - 1) / warm_s,
                compile_s=first_s - warm_s, median_err_px=med,
                ref_status_agreement=agree, ref_drift_px=drift,
                track_features_drift_px=api_drift)


def batched_inputs(b, height, width, n_frames, n_features, seed):
    cfg = flagship_cfg()
    frames, xs, ys, vs = [], [], [], []
    for i in range(b):
        f, _ = translated_sequence(n_frames, height, width, seed + i)
        x, y, v = select(f[0], n_features, cfg)
        frames.append(f), xs.append(x), ys.append(y), vs.append(v)
    return cfg, tuple(np.stack(a) for a in (frames, xs, ys, vs))


def phase_batched(b, height, width, n_frames, n_features, seed=100):
    """track_sequences_batched: every lane against its single stream."""
    from klt.parallel.batched_lk import track_sequences_batched
    from klt.runtime.pipeline import track_sequence
    cfg, (frames, x, y, v) = batched_inputs(b, height, width, n_frames,
                                            n_features, seed)
    args = tuple(jnp.asarray(a) for a in (frames, x, y, v)) + (cfg,)
    out, first_s = timed(track_sequences_batched, *args)
    _, warm_s = timed(track_sequences_batched, *args)
    identical = 0
    for i in range(b):
        single = track_sequence(*(jnp.asarray(a[i])
                                  for a in (frames, x, y, v)), cfg)
        lane = tuple(np.asarray(o)[:, i] for o in out)
        agree, drift, _ = compare_tracks(lane, single)
        check(agree == 1.0, f"sequence {i}: status agreement {agree}")
        check(drift <= 1e-4, f"sequence {i}: drift {drift} px")
        identical += all(np.array_equal(a, np.asarray(s))
                         for a, s in zip(lane, single))
    return dict(aggregate_fps=b * (n_frames - 1) / warm_s,
                compile_s=first_s - warm_s,
                bit_identical_sequences=f"{identical}/{b}")


def phase_replace(height, width, n_frames, n_features, exact_frames,
                  seed=3):
    """track_sequence_replace, then the exact tier GPU vs CPU device."""
    from klt.runtime.pipeline import (track_sequence_replace,
                                      track_sequence_replace_exact)
    cfg = flagship_cfg()
    frames, motion = translated_sequence(n_frames, height, width, seed)
    x, y, val = select(frames[0], n_features, cfg)
    args = (jnp.asarray(frames), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(val), cfg)
    out, first_s = timed(track_sequence_replace, *args)
    _, warm_s = timed(track_sequence_replace, *args)
    xs, ys, vs = (np.asarray(o) for o in out)
    check(xs.shape == (n_frames - 1, n_features), f"shape {xs.shape}")
    live = vs >= 0
    check(np.isfinite(xs[live]).all() and np.isfinite(ys[live]).all(),
          "non-finite positions")
    err = step_errors(x, y, val, xs, ys, vs, motion)
    med = float(np.median(err))
    check(med <= GT_MEDIAN_PX, f"median error {med} px vs true motion")
    check(live[-1].mean() >= 0.5, f"only {live[-1].mean()} of slots live")

    ex_args = (frames[:exact_frames], x, y, val, cfg)
    exact_dev = track_sequence_replace_exact(*ex_args)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        exact_cpu = track_sequence_replace_exact(*ex_args)
    # statuses and replacement picks must agree exactly; positions may
    # differ in the last bits (XLA:CPU contracts mul+add into FMA,
    # XLA:GPU does not; PERF.md)
    check(np.array_equal(exact_dev[2], exact_cpu[2]),
          "exact tier statuses/picks differ from the CPU device")
    ex_live = exact_dev[2] >= 0
    pos_diff = float(np.max(np.hypot(exact_dev[0] - exact_cpu[0],
                                     exact_dev[1] - exact_cpu[1])[ex_live],
                            initial=0.0))
    check(pos_diff <= DRIFT_PX,
          f"exact tier positions differ from the CPU device by {pos_diff}")
    bit_equal = float(np.mean((exact_dev[0] == exact_cpu[0]) &
                              (exact_dev[1] == exact_cpu[1])))
    return dict(fps=(n_frames - 1) / warm_s, compile_s=first_s - warm_s,
                median_err_px=med, live_slots=float(live[-1].mean()),
                exact_frames=exact_frames,
                exact_vs_cpu_max_px=pos_diff,
                exact_vs_cpu_bit_equal_frac=bit_equal,
                table=(x, y, val, xs, ys, vs))


def phase_affine(height, width, n_frames, n_features, seed=4):
    """track_sequence_affine vs the same run at HIGHEST default
    matmul precision (bit for bit: every dot asks for HIGHEST)."""
    from klt.runtime.pipeline import track_sequence_affine
    cfg = affine_cfg()
    frames, motion = translated_sequence(n_frames, height, width, seed)
    x, y, val = select(frames[0], n_features, cfg)
    args = (jnp.asarray(frames), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(val), cfg)
    out, first_s = timed(track_sequence_affine, *args)
    _, warm_s = timed(track_sequence_affine, *args)
    with jax.default_matmul_precision("highest"):
        hi = jax.block_until_ready(track_sequence_affine(*args))
    agree, drift, _ = compare_tracks(out, hi)
    check(agree == 1.0 and drift == 0.0,
          f"differs from the HIGHEST run: agreement {agree}, drift {drift}")
    err = step_errors(x, y, val, *out, motion)
    check(err.size > 0, "no feature survived")
    med = float(np.median(err))
    check(med <= GT_MEDIAN_PX, f"median error {med} px vs true motion")
    alive = float((np.asarray(out[2])[-1] >= 0).mean())
    return dict(fps=(n_frames - 1) / warm_s, compile_s=first_s - warm_s,
                median_err_px=med, alive_fraction=alive,
                vs_highest_drift_px=drift)


def ba_problem(table, height, width, n_keyframes=8):
    """BAProblem from a tracking table [T, N]: keyframes evenly spaced,
    unit-depth landmarks from first observations, identity poses."""
    from klt.slam import BAProblem, tracks_from_table
    x0, y0, v0, xs, ys, vs = table
    X = np.concatenate([x0[None], xs]).T
    Y = np.concatenate([y0[None], ys]).T
    V = np.concatenate([v0[None], vs]).T
    tid, frame, u, v = tracks_from_table(X, Y, V, min_length=3)
    kfs = np.linspace(0, X.shape[1] - 1, n_keyframes).astype(np.int32)
    kf = {int(f): i for i, f in enumerate(kfs)}
    keep = np.isin(frame, kfs)
    tid, frame, u, v = tid[keep], frame[keep], u[keep], v[keep]
    ids, counts = np.unique(tid, return_counts=True)
    keep = np.isin(tid, ids[counts >= 2])
    tid, frame, u, v = tid[keep], frame[keep], u[keep], v[keep]
    _, lm_idx = np.unique(tid, return_inverse=True)
    cam_idx = np.asarray([kf[int(f)] for f in frame], np.int32)
    check(lm_idx.size > 0, "no multi-keyframe tracks")
    n_lm = int(lm_idx.max()) + 1
    fx = fy = 0.9 * width
    cx, cy = width / 2.0, height / 2.0
    first = np.full(n_lm, -1, np.int64)
    for m in range(len(lm_idx) - 1, -1, -1):
        first[lm_idx[m]] = m
    lm0 = np.stack([(u[first] - cx) / fx, (v[first] - cy) / fy,
                    np.ones(n_lm)], 1).astype(np.float32)
    return BAProblem(
        R=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                           (n_keyframes, 3, 3)),
        t=jnp.zeros((n_keyframes, 3), jnp.float32),
        landmarks=jnp.asarray(lm0), cam_idx=jnp.asarray(cam_idx),
        lm_idx=jnp.asarray(lm_idx.astype(np.int32)),
        uv=jnp.asarray(np.stack([u, v], -1).astype(np.float32)),
        weight=jnp.ones(len(cam_idx), jnp.float32),
        fx=fx, fy=fy, cx=cx, cy=cy)


def phase_ba(table, height, width, iterations=BA_ITERATIONS):
    """bundle_adjust_cg on tracks from the replacement phase."""
    from klt.slam import bundle_adjust_cg
    prob = ba_problem(table, height, width)
    (_, _, _, costs), secs = timed(bundle_adjust_cg, prob,
                                   iterations=iterations)
    costs = np.asarray(costs)
    check(np.isfinite(costs).all(), "non-finite BA cost")
    check(costs[-1] < costs[0], f"BA cost did not decrease: {costs}")
    return dict(observations=int(prob.uv.shape[0]),
                landmarks=int(prob.landmarks.shape[0]),
                cost_first=float(costs[0]), cost_last=float(costs[-1]),
                seconds=secs)


def phase_four_devices(n_devices, b, height, width, n_frames, n_features,
                       seed=100):
    """Sharded batched tracking and sharded BA over a `data` mesh of
    n_devices, each against its one-device result."""
    from klt.parallel.batch import track_batch
    from klt.parallel.batched_lk import track_sequences_batched
    from klt.parallel.mesh import make_mesh
    from klt.slam import bundle_adjust_cg
    devs = jax.devices()[:n_devices]
    mesh = make_mesh({"data": n_devices}, devices=devs)
    cfg, (frames, x, y, v) = batched_inputs(b, height, width, n_frames,
                                            n_features, seed)
    one = jax.device_put((frames, x, y, v), devs[0])
    single = jax.block_until_ready(track_sequences_batched(*one, cfg))
    sharded, first_s = timed(track_batch, frames, x, y, v, cfg, mesh=mesh)
    _, warm_s = timed(track_batch, frames, x, y, v, cfg, mesh=mesh)
    agree, drift, _ = compare_tracks(sharded, single)
    check(agree == 1.0, f"sharded status agreement {agree}")
    check(drift <= 1e-4, f"sharded drift {drift} px")
    identical = all(np.array_equal(np.asarray(a), np.asarray(s))
                    for a, s in zip(sharded, single))
    shard_devs = {s.device for s in sharded[0].addressable_shards}
    check(len(shard_devs) == n_devices,
          f"table shards on {len(shard_devs)} devices")
    check(all(s.data.shape[1] == b // n_devices
              for s in sharded[0].addressable_shards),
          "uneven sequence shards")
    mem = {}
    for d in devs:
        st = d.memory_stats() or {}
        mem[str(d.id)] = st.get("peak_bytes_in_use")

    xs, ys, vs = (np.asarray(a)[:, 0] for a in single)
    prob = ba_problem((x[0], y[0], v[0], xs, ys, vs), height, width)
    _, _, _, c_one = bundle_adjust_cg(prob, iterations=BA_ITERATIONS)
    _, _, _, c_mesh = bundle_adjust_cg(prob, mesh=mesh,
                                       iterations=BA_ITERATIONS)
    c_one, c_mesh = np.asarray(c_one), np.asarray(c_mesh)
    rel = float(np.max(np.abs(c_mesh - c_one) / np.abs(c_one)))
    check(rel <= 1e-3, f"sharded BA cost differs by {rel}")
    check(c_mesh[-1] < c_mesh[0], f"sharded BA did not descend: {c_mesh}")
    return dict(aggregate_fps=b * (n_frames - 1) / warm_s,
                compile_s=first_s - warm_s, bit_identical=identical,
                shard_devices=len(shard_devs), peak_bytes_per_device=mem,
                ba_cost_rel_diff=rel)


# --------------------------------------------------------------------- #

def _fmt(d):
    return ", ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in d.items() if k != "table")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card phase")
    ns = ap.parse_args(argv)

    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {platform!r})",
              file=sys.stderr)
        return 1
    if len(devs) < ns.devices:
        print(f"chip_smoke: need {ns.devices} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 1
    from klt.utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    klt.set_verbosity(0)
    card = card_line()

    def report(name, d):
        print(f"{name}: {_fmt(d)} [{card}]", flush=True)

    report("phase 0 device", dict(platform=platform,
                                  kind=devs[0].device_kind,
                                  count=len(devs)))
    if ns.devices == 4:
        report("phase 4-card", phase_four_devices(4, BATCH, **FLAGSHIP))
    else:
        for name, h, w, n, cfg in (
                ("320x240", 240, 320, 150, flagship_cfg()),
                ("640x480", 480, 640, 2000, affine_cfg())):
            for r, d in phase_lk_kernel(h, w, n, cfg).items():
                report(f"phase 1 lk kernel {name} level {r}", d)
        report("phase 2 single stream", phase_single_stream(**FLAGSHIP))
        report("phase 3 batched", phase_batched(BATCH, **FLAGSHIP))
        rep = phase_replace(**REPLACE)
        report("phase 4 replacement", rep)
        report("phase 5 affine", phase_affine(**AFFINE))
        report("phase 6 bundle adjustment",
               phase_ba(rep["table"], REPLACE["height"], REPLACE["width"]))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
