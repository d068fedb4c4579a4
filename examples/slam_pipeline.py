"""Example: tracking-to-mapping pipeline (beyond-reference extension).

Runs the device-resident KLT front end (whole-sequence compiled scan
with in-scan lost-feature replacement) over a PGM sequence, converts
the feature table to observation chains, selects keyframes by feature
overlap, and refines a bundle-adjustment problem (poses + landmarks)
from the tracks with the matrix-free Schur/CG solver.

Monocular initialization: unit-depth back-projected landmarks plus
absolute poses from slam.frontend.keyframe_pose_graph_init (tiny
two-pose BAs on shared tracks -> SE(3) pose graph), so the full
pipeline is frames -> FeatureTable -> chains -> keyframes ->
pose graph -> distributed BA; see tests/test_slam.py for accuracy
validation on synthetic geometry.

Usage:
    python examples/slam_pipeline.py [dataset] [nFeatures] [nFrames]
                                     [--host] [--chunk N]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import klt  # noqa: E402
from klt.io.dataset import find_dataset, ImageSequence  # noqa: E402
from klt.slam import (tracks_from_table, select_keyframes,  # noqa: E402
                          BAProblem, bundle_adjust, bundle_adjust_cg)
from klt.slam.frontend import keyframe_pose_graph_init  # noqa: E402


def frontend_device(seq, n_features, n_frames, cfg, chunk):
    """Device-resident front end: chunked compiled scans with in-scan
    replacement (runtime.pipeline.track_sequence_replace)."""
    from klt.runtime.pipeline import track_sequence_replace

    tracker = klt.KLTracker(cfg)
    fl = klt.FeatureList.create(n_features)
    img0 = seq[0]
    tracker.select_good_features(img0, fl)
    ft = klt.FeatureTable.create(n_frames, n_features)
    ft.store_list(fl, 0)

    x = jnp.asarray(fl.x)
    y = jnp.asarray(fl.y)
    v = jnp.asarray(fl.val)
    t0 = time.perf_counter()
    done = 1
    while done < n_frames:
        hi = min(done + chunk, n_frames)
        # chunk carries its first frame for the pair step
        frames = np.stack([seq[i] for i in range(done - 1, hi)])
        xs, ys, vs = track_sequence_replace(jnp.asarray(frames), x, y,
                                            v, cfg)
        xs, ys, vs = np.asarray(xs), np.asarray(ys), np.asarray(vs)
        for k in range(xs.shape[0]):
            ft.x[:, done + k] = xs[k]
            ft.y[:, done + k] = ys[k]
            ft.val[:, done + k] = vs[k]
        x, y, v = jnp.asarray(xs[-1]), jnp.asarray(ys[-1]), \
            jnp.asarray(vs[-1])
        done = hi
    dt = time.perf_counter() - t0
    return ft, (n_frames - 1) / dt


def frontend_host(seq, n_features, n_frames, cfg):
    """Reference-style host loop (KLTracker + native replacement)."""
    tracker = klt.KLTracker(cfg)
    fl = klt.FeatureList.create(n_features)
    ft = klt.FeatureTable.create(n_frames, n_features)
    img1 = seq[0]
    tracker.select_good_features(img1, fl)
    ft.store_list(fl, 0)
    t0 = time.perf_counter()
    for i in range(1, n_frames):
        img2 = seq[i]
        tracker.track_features(img1, img2, fl)
        tracker.replace_lost_features(img2, fl)
        ft.store_list(fl, i)
        img1 = img2
    dt = time.perf_counter() - t0
    return ft, (n_frames - 1) / dt


def main():
    import argparse
    ap = argparse.ArgumentParser(description="KLT front-end -> SLAM "
                                 "back-end pipeline")
    ap.add_argument("dataset", nargs="?", default="images_provided")
    ap.add_argument("n_features", nargs="?", type=int, default=150)
    ap.add_argument("n_frames", nargs="?", type=int, default=10)
    ap.add_argument("--host", action="store_true",
                    help="reference-style host loop instead of the "
                         "device scan")
    ap.add_argument("--chunk", type=int, default=64,
                    help="device-scan chunk length")
    ns = ap.parse_args()
    dataset, n_features, n_frames = ns.dataset, ns.n_features, ns.n_frames
    host, chunk = ns.host, ns.chunk

    path = find_dataset(dataset)
    if path is None:
        sys.exit(f"dataset '{dataset}' not found")
    seq = ImageSequence(path)
    n_frames = min(n_frames, len(seq))

    cfg = klt.TrackingConfig(sequential_mode=True)
    if host:
        ft, fps = frontend_host(seq, n_features, n_frames, cfg)
    else:
        ft, fps = frontend_device(seq, n_features, n_frames, cfg, chunk)
    print(f"front end: {n_frames - 1} frame pairs at {fps:.1f} fps "
          f"({'host loop' if host else 'device scan + in-scan replace'})")

    # front-end -> back-end handoff
    tid, frame, u, v = tracks_from_table(ft.x, ft.y, ft.val, min_length=3)
    if len(tid) == 0:
        sys.exit("no tracks of length >= 3; nothing to adjust")
    kfs = select_keyframes(ft.val, overlap_thresh=0.8)
    if len(kfs) < 3:
        # short well-tracked clip: take evenly spaced keyframes so the
        # BA demo has multiple views
        kfs = np.arange(0, n_frames, max(1, n_frames // 4), dtype=np.int32)
    print(f"{tid.max() + 1} tracks / {len(tid)} observations; "
          f"{len(kfs)} keyframes")

    # keep observations on keyframes only, remap frame -> pose index
    kf_set = {int(f): i for i, f in enumerate(kfs)}
    keep = np.isin(frame, kfs)
    tid, frame, u, v = tid[keep], frame[keep], u[keep], v[keep]
    # tracks must appear on >= 2 keyframes to constrain anything
    ids, counts = np.unique(tid, return_counts=True)
    keep = np.isin(tid, ids[counts >= 2])
    tid, frame, u, v = tid[keep], frame[keep], u[keep], v[keep]
    remap = {old: new for new, old in enumerate(np.unique(tid))}
    lm_idx = np.asarray([remap[t] for t in tid], np.int32)
    cam_idx = np.asarray([kf_set[int(f)] for f in frame], np.int32)

    if len(lm_idx) == 0:
        sys.exit("no multi-keyframe tracks; nothing to adjust")
    n_pose = len(kfs)
    n_lm = int(lm_idx.max()) + 1
    h, w = seq.nrows, seq.ncols
    fx = fy = 0.9 * w
    cx, cy = w / 2.0, h / 2.0

    # unit-depth back-projection from each landmark's first observation
    lm0 = np.zeros((n_lm, 3), np.float32)
    first = np.full(n_lm, -1, np.int64)
    for m in range(len(lm_idx) - 1, -1, -1):
        first[lm_idx[m]] = m
    lm0[:, 0] = (u[first] - cx) / fx
    lm0[:, 1] = (v[first] - cy) / fy
    lm0[:, 2] = 1.0

    # front end -> POSE GRAPH -> BA: relative poses from tiny two-pose
    # BAs on shared tracks, chained through the SE(3) pose graph
    R_init, t_init, pg_costs = keyframe_pose_graph_init(
        lm_idx, cam_idx, u, v, n_pose, fx, fy, cx, cy)
    print(f"pose graph: cost {float(pg_costs[0]):.3e} -> "
          f"{float(pg_costs[-1]):.3e}")
    prob = BAProblem(
        R=jnp.asarray(R_init),
        t=jnp.asarray(t_init),
        landmarks=jnp.asarray(lm0),
        cam_idx=jnp.asarray(cam_idx), lm_idx=jnp.asarray(lm_idx),
        uv=jnp.asarray(np.stack([u, v], -1).astype(np.float32)),
        weight=jnp.ones(len(cam_idx), jnp.float32),
        fx=fx, fy=fy, cx=cx, cy=cy)

    mesh = None
    if len(jax.devices()) > 1:
        from klt.parallel.mesh import make_mesh
        mesh = make_mesh({"data": len(jax.devices())})

    t0 = time.perf_counter()
    if n_pose * n_lm > 50_000:  # dense W would not scale
        R, t, lm, costs = bundle_adjust_cg(prob, mesh=mesh,
                                           iterations=20)
        solver = "schur-cg"
    else:
        R, t, lm, costs = bundle_adjust(prob, mesh=mesh, iterations=20)
        solver = "schur-dense"
    jax.block_until_ready(costs)
    ba_s = time.perf_counter() - t0
    costs = np.asarray(costs)
    rms0 = float(np.sqrt(costs[0] / max(len(cam_idx), 1)))
    rms1 = float(np.sqrt(costs[-1] / max(len(cam_idx), 1)))
    print(f"BA ({solver}): {n_pose} keyframes x {n_lm} landmarks, "
          f"{len(cam_idx)} observations, {ba_s:.1f}s")
    print(f"reprojection rms: {rms0:.3f} -> {rms1:.3f} px")
    print(json.dumps({
        "dataset": dataset, "frontend_fps": round(fps, 1),
        "n_frames": n_frames, "n_features": n_features,
        "n_keyframes": int(n_pose), "n_landmarks": int(n_lm),
        "n_observations": int(len(cam_idx)), "ba_solver": solver,
        "ba_seconds": round(ba_s, 2),
        "reproj_rms_px_before": round(rms0, 4),
        "reproj_rms_px_after": round(rms1, 4)}))


if __name__ == "__main__":
    main()
