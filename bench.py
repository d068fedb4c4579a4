"""Benchmark: KLT tracking throughput + accuracy vs the CPU reference.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "configs": {...one entry per BASELINE.json config...}}

Primary metric mirrors the reference's own harness (clock() around
KLTTrackFeatures only, src/V3/example3GPU.c:61-65) on its profiled
config: images_provided, 150 features, 2-level pyramid, sequential mode.
Baseline: 11.85 ms per frame-pair on the reference CPU
(src/V1/example3_analysis.txt:46) = 84.39 frames/s.

The BASELINE.json configs covered (see that file):
  1. images_provided 150 feat           -> primary metric
  2. images_traffic 500 feat, full 551 frames, per-frame replacement
     (device-resident, in-scan) + writeFeatures output
  3. images_laptops 2000 feat, affine consistency, 4-level pyramid
  4. batched multi-sequence: 3 datasets x 4096 features concurrently
  5. front-end -> keyframes -> distributed Schur/CG bundle adjustment

Timing loops repeat whole-sequence device programs (so the per-pair
cost amortizes dispatch) with perturbed starts so XLA cannot hoist the
work.  The datasets are read from DATA; making the benchmark run on
seeded data on the GPU is the next step (ROADMAP 1.1).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CPU_BASELINE_FPS = 1.0 / 0.01185  # reference: 11.85 ms / frame-pair
# Reference CPU measured at -O2 with tools/fixtures/bench_ref.c on the
# configs the reference never benchmarked itself:
CPU_TRAFFIC_REPLACE_FPS = 16.15   # traffic, 500 feat, replacement
CPU_LAPTOPS_AFFINE_FPS = 12.37    # laptops, 2000 feat, affine=2,
#                                   4-level/ss2 pyramid (config-matched;
#                                   the 2-level default measured 5.87)
DATA = "/root/reference/data"

# --- accuracy contract (ONE place) -----------------------------------
# BASELINE.md: <=0.5 px drift vs the CPU reference.  Any probe row
# (a lower-precision or unrolled variant) may only become a headline or a
# default if its OWN parity fields pass these thresholds.
CONTRACT_MAX_DRIFT_PX = 0.5
CONTRACT_MIN_WITHIN_HALF_PX = 0.95
CONTRACT_MIN_SAME_DET_WITHIN = 0.99


def contract_ok(entry) -> bool:
    """Evaluate the accuracy contract on whichever parity fields the
    entry carries.  No parity fields -> fail closed (a row without
    accuracy evidence can never be a headline)."""
    checks = []
    if "lane0_status_agreement" in entry:
        checks.append(entry["lane0_status_agreement"] == 1.0)
    if "lane0_drift_px_vs_cpu_golden" in entry:
        checks.append(entry["lane0_drift_px_vs_cpu_golden"]
                      <= CONTRACT_MAX_DRIFT_PX)
    if "drift_px_vs_cpu_golden" in entry:
        checks.append(entry["drift_px_vs_cpu_golden"]
                      <= CONTRACT_MAX_DRIFT_PX)
    if "status_agreement" in entry and "lane0_status_agreement" \
            not in entry and "drift_px_vs_cpu_golden" not in entry:
        checks.append(entry["status_agreement"] >= 0.99)
    if "within_half_px" in entry:
        checks.append(entry["within_half_px"]
                      >= CONTRACT_MIN_WITHIN_HALF_PX)
    if "within_half_px_same_detection" in entry:
        checks.append(entry["within_half_px_same_detection"]
                      >= CONTRACT_MIN_SAME_DET_WITHIN)
    if "within_half_px_vs_exact" in entry:
        checks.append(entry["within_half_px_vs_exact"]
                      >= CONTRACT_MIN_SAME_DET_WITHIN)
    if "status_agreement_vs_exact" in entry:
        checks.append(entry["status_agreement_vs_exact"] >= 0.99)
    return bool(checks) and all(checks)


def _seed(klt, frames0, n, cfg):
    tracker = klt.KLTracker(cfg)
    fl = klt.FeatureList.create(n)
    tracker.select_good_features(frames0, fl)
    return fl


def _load(klt, name, lo, hi):
    d = os.path.join(DATA, name)
    return np.stack([klt.read_pgm(os.path.join(d, f"img{i}.pgm"))
                     for i in range(lo, hi)])


def bench_flagship(jax, jnp, klt, cfg, result):
    from klt.runtime.pipeline import track_sequence
    from klt.io.features_io import read_feature_table

    frames = _load(klt, "images_provided", 0, 10)
    fl = _seed(klt, frames[0], 150, cfg)
    frames_dev = jax.device_put(frames)
    x0, y0, v0 = (jax.device_put(a) for a in (fl.x, fl.y, fl.val))
    n_pairs = frames.shape[0] - 1
    reps = int(os.environ.get("KLT_BENCH_REPS", "100"))

    # whole-chunk pyramid precompute self-selects (bit-exact toggle,
    # both points measured; KLT_BENCH_PRE narrows the sweep)
    psweep = tuple(int(s) for s in os.environ.get(
        "KLT_BENCH_PRE", "1,0").split(","))
    pre_saved = os.environ.get("KLT_PRECOMP_PYR")
    best = float("inf")
    best_pre = None
    for pre in psweep:
        os.environ["KLT_PRECOMP_PYR"] = str(pre)

        @jax.jit
        def timed_run(frames, x, y, v):
            def body(i, acc):
                xs, ys, vs = track_sequence(frames, x + 1e-4 * i, y, v,
                                            cfg)
                return acc + xs[-1]
            return jax.lax.fori_loop(0, reps, body, jnp.zeros_like(x))

        r = timed_run(frames_dev, x0, y0, v0)
        jax.block_until_ready(r)
        for _ in range(3):
            t0 = time.perf_counter()
            r = timed_run(frames_dev, x0, y0, v0)
            jax.block_until_ready(r)
            dt = (time.perf_counter() - t0) / (reps * n_pairs)
            if dt < best:
                best, best_pre = dt, bool(pre)
    if pre_saved is None:
        os.environ.pop("KLT_PRECOMP_PYR", None)
    else:
        os.environ["KLT_PRECOMP_PYR"] = pre_saved
    fps = 1.0 / best
    result["precomp_pyramids"] = best_pre

    tables = track_sequence(frames_dev, x0, y0, v0, cfg)
    jax.block_until_ready(tables)
    golden = "/root/reference/src/V1/feat/features2.ft"
    if os.path.exists(golden):
        xs, ys, vs = (np.asarray(t) for t in tables)
        oracle = read_feature_table(golden)
        dmax, agree, total = 0.0, 0, 0
        for t in range(n_pairs):
            ox, oy, ov = oracle.x[:, t], oracle.y[:, t], oracle.val[:, t]
            agree += int((vs[t] == ov).sum())
            total += len(ov)
            both = (vs[t] >= 0) & (ov >= 0)
            if both.any():
                d = np.hypot(xs[t] - ox, ys[t] - oy)[both]
                dmax = max(dmax, float(d.max()))
        result["drift_px_vs_cpu_golden"] = dmax
        result["status_agreement"] = agree / total
    result["value"] = round(fps, 2)
    result["vs_baseline"] = round(fps / CPU_BASELINE_FPS, 2)


def bench_flagship_batched(jax, jnp, klt, out):
    """Per-device THROUGHPUT on the flagship config: B independent
    copies of the images_provided sequence tracked concurrently by the
    batched kernel path (one LK kernel invocation per level per step
    for all B*150 features).  The single-stream number above is the
    latency metric; this is what one device sustains when fed enough
    independent work."""
    from klt.parallel.batched_lk import track_sequences_batched

    from klt.io.features_io import read_feature_table

    cfg = klt.TrackingConfig(sequential_mode=True)
    frames = _load(klt, "images_provided", 0, 10)
    fl = _seed(klt, frames[0], 150, cfg)
    n_pairs = frames.shape[0] - 1
    best_entry = None
    bsweep = tuple(int(s) for s in os.environ.get(
        "KLT_BENCH_B", "16,32").split(","))
    # precomp sweep: whole-chunk pyramid precompute is bit-exact (same
    # stacks, same per-step program — tests/test_parallel.py), so the
    # headline may pick whichever point is faster per batch size.
    psweep = tuple(int(s) for s in os.environ.get(
        "KLT_BENCH_PRE", "1,0").split(","))
    pre_saved = os.environ.get("KLT_PRECOMP_PYR")
    for b in bsweep:
        fb = jnp.asarray(np.broadcast_to(
            frames, (b,) + frames.shape).copy())
        x = jnp.asarray(np.broadcast_to(fl.x, (b, 150)).copy())
        y = jnp.asarray(np.broadcast_to(fl.y, (b, 150)).copy())
        v = jnp.asarray(np.broadcast_to(fl.val, (b, 150)).copy())
        reps = int(os.environ.get("KLT_BENCH_REPS", "10"))

        b_best = None
        for pre in psweep:
            os.environ["KLT_PRECOMP_PYR"] = str(pre)

            # reps folded into one device program (like bench_flagship)
            # so the number is device throughput, not dispatch latency
            @jax.jit
            def timed_run(fb, x, y, v):
                def body(i, acc):
                    xs, ys, vs = track_sequences_batched(
                        fb, x + 1e-4 * i.astype(jnp.float32), y, v, cfg)
                    return acc + xs[-1]
                return jax.lax.fori_loop(0, reps, body,
                                         jnp.zeros_like(x))

            r = timed_run(fb, x, y, v)
            jax.block_until_ready(r)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                r = timed_run(fb, x, y, v)
                jax.block_until_ready(r)
                best = min(best, (time.perf_counter() - t0) / reps)
            agg = b * n_pairs / best
            entry = {
                "batch": b,
                "precomp_pyramids": bool(pre),
                "frames": int(frames.shape[0]),
                "aggregate_frames_per_s": round(agg, 1),
                "vs_baseline_fps": round(agg / CPU_BASELINE_FPS, 1),
                "tracked_features_per_s": round(agg * 150, 0),
            }
            if b_best is None or (entry["aggregate_frames_per_s"] >
                                  b_best["aggregate_frames_per_s"]):
                b_best = entry
        entry = b_best
        # accuracy: batch lane 0 must match the single-stream goldens
        # (checked once per B — the precomp toggle is bit-exact)
        rt = track_sequences_batched(fb, x, y, v, cfg)
        xs0 = np.asarray(rt[0][:, 0])
        ys0 = np.asarray(rt[1][:, 0])
        vs0 = np.asarray(rt[2][:, 0])
        entry["final_live_features_seq0"] = int((vs0[-1] >= 0).sum())
        golden = "/root/reference/src/V1/feat/features2.ft"
        if os.path.exists(golden):
            oracle = read_feature_table(golden)
            dmax, agree, total = 0.0, 0, 0
            for t in range(n_pairs):
                ox, oy = oracle.x[:, t], oracle.y[:, t]
                ov = oracle.val[:, t]
                agree += int((vs0[t] == ov).sum())
                total += len(ov)
                both = (vs0[t] >= 0) & (ov >= 0)
                if both.any():
                    d = np.hypot(xs0[t] - ox, ys0[t] - oy)[both]
                    dmax = max(dmax, float(d.max()))
            entry["lane0_drift_px_vs_cpu_golden"] = dmax
            entry["lane0_status_agreement"] = agree / total
        if (best_entry is None or entry["aggregate_frames_per_s"] >
                best_entry["aggregate_frames_per_s"]):
            best_entry = entry
        out[f"flagship_batched_b{b}"] = entry
    if pre_saved is None:
        os.environ.pop("KLT_PRECOMP_PYR", None)
    else:
        os.environ["KLT_PRECOMP_PYR"] = pre_saved

    out["flagship_batched_throughput"] = dict(best_entry)


def _table_parity(entry, x_full, y_full, v_full, fixture):
    """Per-config accuracy vs the reference CPU oracle table
    (tests/fixtures/*.ft, regenerated by tools/fixtures/gen_tables.sh
    from a -O0 -ffp-contract=off reference build = golden semantics).

    x_full/y_full/v_full: [N, T] feature tables INCLUDING the seed
    selection at column 0, aligned with the oracle's columns.  Emits
    klt.utils.parity.table_parity_stats — liveness agreement,
    co-live drift, and the SAME-DETECTION drift metrics that exclude
    slots whose replacement picks legitimately diverged (an exact
    response tie refills a slot with a different feature, after which
    its positions measure nothing; see utils/parity.py).
    """
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "tests", "fixtures", fixture)
    if not os.path.exists(path):
        entry["parity"] = f"oracle missing: tools/fixtures/gen_tables.sh"
        return
    from klt.io.features_io import read_feature_table
    from klt.utils.parity import table_parity_stats
    oracle = read_feature_table(path)
    x_full = np.asarray(x_full)
    if x_full.shape[0] != oracle.x.shape[0]:
        entry["parity"] = (f"skipped: {x_full.shape[0]} features vs "
                           f"oracle {oracle.x.shape[0]} (smoke run)")
        return
    t_max = min(x_full.shape[1], oracle.x.shape[1])
    args = (x_full[:, :t_max], np.asarray(y_full)[:, :t_max],
            np.asarray(v_full)[:, :t_max], oracle.x[:, :t_max],
            oracle.y[:, :t_max], oracle.val[:, :t_max])
    entry.update(table_parity_stats(*args))
    st50 = table_parity_stats(*args, horizon=min(51, t_max))
    entry["within_half_px_first50"] = st50["within_half_px"]
    entry["within_half_px_same_detection_first50"] = \
        st50["within_half_px_same_detection"]
    entry["drift_px_median_first50"] = st50["drift_px_median"]


def bench_traffic_replace(jax, jnp, klt, out):
    """Config 2: 500 features, full 551-frame sequence, per-frame
    device-resident replacement inside the scan, writeFeatures output.

    The headline row runs the BIT-EXACT driver (ops/lk_exact +
    ops/replace_exact + host tie repair): its table reproduces the
    reference CPU tracker's bit-for-bit (measured drift p99 0.0 px,
    same_detection_frac 1.0 over all 551 frames).  The fast tier keeps
    its own row as the throughput point, with honest divergence
    metrics (ulp position drift flips replacement stamp geometry, so
    its picks cascade away from the reference's)."""
    from klt.runtime.pipeline import (track_sequence_replace,
                                          track_sequence_replace_exact)

    cfg = klt.TrackingConfig(sequential_mode=True)
    t_frames = int(os.environ.get("KLT_BENCH_TRAFFIC_FRAMES", "551"))
    n_feat = int(os.environ.get("KLT_BENCH_TRAFFIC_FEAT", "500"))
    frames = _load(klt, "images_traffic", 1, 1 + t_frames)
    fl = _seed(klt, frames[0], n_feat, cfg)
    n_frames = frames.shape[0]
    chunk = min(128, max(n_frames - 1, 1))

    x = jnp.asarray(fl.x)
    y = jnp.asarray(fl.y)
    v = jnp.asarray(fl.val)
    ft = klt.FeatureTable.create(n_frames, n_feat)
    ft.store_list(fl, 0)

    # ---- bit-exact headline row -----------------------------------
    dev_frames = jax.device_put(frames)
    v0 = fl.val.astype(np.int32)
    xs, ys, vs = track_sequence_replace_exact(  # compile + collect
        dev_frames, fl.x, fl.y, v0, cfg)
    ft.x[:, 1:] = xs.T
    ft.y[:, 1:] = ys.T
    ft.val[:, 1:] = vs.T
    t0 = time.perf_counter()
    track_sequence_replace_exact(dev_frames, fl.x, fl.y, v0, cfg)
    dt = time.perf_counter() - t0
    klt.write_feature_table(ft, "/tmp/traffic_features.ft")
    entry = {
        "frames_per_s": round((n_frames - 1) / dt, 1),
        "vs_measured_cpu_baseline": round(
            (n_frames - 1) / dt / CPU_TRAFFIC_REPLACE_FPS, 1),
        "frames": int(n_frames),
        "tier": "bit-exact (lk_exact + replace_exact + tie repair)",
        "final_live_features": int((vs[-1] >= 0).sum()),
        "write_features_output": "/tmp/traffic_features.ft",
    }
    _table_parity(entry, ft.x, ft.y, ft.val, "table_traffic_500r.ft")
    entry["contract_ok"] = contract_ok(entry)
    out["traffic_500feat_replace_551f"] = entry

    # pre-stage the frame chunks on device: the timed loop measures
    # tracking + in-scan replacement, not the upload
    staged = {}
    done = 1
    while done < n_frames:
        hi = min(done + chunk, n_frames)
        staged[done] = jax.device_put(frames[done - 1:hi])
        done = hi

    def run(x, y, v, collect):
        done = 1
        while done < n_frames:
            hi = min(done + chunk, n_frames)
            fb = staged[done]
            xs, ys, vs = track_sequence_replace(fb, x, y, v, cfg)
            x, y, v = xs[-1], ys[-1], vs[-1]
            if collect:
                xs = np.asarray(xs)
                ys_ = np.asarray(ys)
                vs = np.asarray(vs)
                for k in range(xs.shape[0]):
                    ft.x[:, done + k] = xs[k]
                    ft.y[:, done + k] = ys_[k]
                    ft.val[:, done + k] = vs[k]
            done = hi
        jax.block_until_ready((x, y, v))
        return x, y, v

    run(x, y, v, collect=True)  # compile + collect the table output
    t0 = time.perf_counter()
    xf, yf, vf = run(x, y, v, collect=False)
    dt = time.perf_counter() - t0
    entry = {
        "frames_per_s": round((n_frames - 1) / dt, 1),
        "vs_measured_cpu_baseline": round(
            (n_frames - 1) / dt / CPU_TRAFFIC_REPLACE_FPS, 1),
        "frames": int(n_frames),
        "tier": "fast (in-scan device replacement)",
        "final_live_features": int((np.asarray(vf) >= 0).sum()),
    }
    _table_parity(entry, ft.x, ft.y, ft.val, "table_traffic_500r.ft")
    out["traffic_500feat_replace_551f_fast"] = entry


def bench_laptops_affine(jax, jnp, klt, out):
    """Config 3: 2000 features, affine consistency check, 4-level
    pyramid, subpixel LK, on the 640x480 laptops sequence."""
    from klt.runtime.pipeline import track_sequence_affine

    cfg = klt.TrackingConfig(sequential_mode=True,
                             affine_consistency_check=2,
                             n_pyramid_levels=4, subsampling=2)
    n_frames = int(os.environ.get("KLT_BENCH_AFFINE_FRAMES", "201"))
    n_feat = int(os.environ.get("KLT_BENCH_AFFINE_FEAT", "2000"))
    frames = _load(klt, "images_laptops", 1, 1 + n_frames)
    fl = _seed(klt, frames[0], n_feat, cfg)
    fd = jax.device_put(frames)
    x0, y0, v0 = (jax.device_put(a) for a in (fl.x, fl.y, fl.val))
    n_pairs = frames.shape[0] - 1

    r = track_sequence_affine(fd, x0, y0, v0, cfg)
    jax.block_until_ready(r)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        rt = track_sequence_affine(fd, x0 + 1e-4, y0, v0, cfg)
        jax.block_until_ready(rt)
        best = min(best, (time.perf_counter() - t0) / n_pairs)
    # parity fields come from the CLEAN-seed run (r): the 1e-4 px
    # timing perturbation can flip marginal affine accept/reject
    # decisions and understate parity for reasons unrelated to the
    # tracker
    vs_final = np.asarray(r[2][-1])
    entry = {
        "frames_per_s": round(1.0 / best, 1),
        "vs_measured_cpu_baseline": round(
            1.0 / best / CPU_LAPTOPS_AFFINE_FPS, 2),
        "frames": int(frames.shape[0]),
        "final_live_features": int((vs_final >= 0).sum()),
    }
    _table_parity(
        entry,
        np.concatenate([np.asarray(x0)[:, None], np.asarray(r[0]).T], 1),
        np.concatenate([np.asarray(y0)[:, None], np.asarray(r[1]).T], 1),
        np.concatenate([np.asarray(v0)[:, None], np.asarray(r[2]).T], 1),
        "table_laptops_2000aff.ft")
    out["laptops_2000feat_affine_4level"] = entry


def bench_laptops_affine_batched(jax, jnp, klt, out):
    """Config 3 THROUGHPUT point (VERDICT r4 item 1): B disjoint
    windows of the laptops sequence tracked concurrently with the
    affine consistency check — the flagship's 47x->102x batching move
    applied to the affine config.  Window 0 starts at img1, so its
    first tracked columns compare against the same reference oracle
    table as the single-stream row (which stays as the latency
    metric)."""
    from klt.parallel.batched_affine import (
        track_sequences_affine_batched)

    cfg = klt.TrackingConfig(sequential_mode=True,
                             affine_consistency_check=2,
                             n_pyramid_levels=4, subsampling=2)
    n_feat = int(os.environ.get("KLT_BENCH_AFFB_FEAT", "2000"))
    f_win = int(os.environ.get("KLT_BENCH_AFFB_FRAMES", "101"))
    bsweep = tuple(int(s) for s in os.environ.get(
        "KLT_BENCH_AFFB_B", "4,8").split(","))
    best_entry = None
    for b in bsweep:
        frames = _load(klt, "images_laptops", 1, 1 + b * f_win)
        fb_np = frames.reshape((b, f_win) + frames.shape[1:])
        seeds = [_seed(klt, fb_np[i, 0], n_feat, cfg)
                 for i in range(b)]
        fd = jax.device_put(fb_np)
        x0 = jnp.asarray(np.stack([s.x for s in seeds]))
        y0 = jnp.asarray(np.stack([s.y for s in seeds]))
        v0 = jnp.asarray(np.stack([s.val for s in seeds]))
        n_pairs = f_win - 1

        r = track_sequences_affine_batched(fd, x0, y0, v0, cfg)
        jax.block_until_ready(r)
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            rt = track_sequences_affine_batched(fd, x0 + 1e-4, y0, v0,
                                                cfg)
            jax.block_until_ready(rt)
            best = min(best, (time.perf_counter() - t0))
        agg = b * n_pairs / best
        vs_final = np.asarray(r[2][-1])
        entry = {
            "batch": b,
            "frames": int(f_win),
            "aggregate_frames_per_s": round(agg, 1),
            "vs_measured_cpu_baseline": round(
                agg / CPU_LAPTOPS_AFFINE_FPS, 2),
            "final_live_features_seq0": int((vs_final[0] >= 0).sum()),
        }
        # parity from the CLEAN-seed run, window 0 vs the reference
        # oracle (same fixture as the single-stream row; truncated to
        # the fixture's 60 frames by _table_parity)
        _table_parity(
            entry,
            np.concatenate([np.asarray(x0)[0][:, None],
                            np.asarray(r[0][:, 0]).T], 1),
            np.concatenate([np.asarray(y0)[0][:, None],
                            np.asarray(r[1][:, 0]).T], 1),
            np.concatenate([np.asarray(v0)[0][:, None],
                            np.asarray(r[2][:, 0]).T], 1),
            "table_laptops_2000aff.ft")
        entry["contract_ok"] = contract_ok(entry)
        out[f"laptops_affine_batched_b{b}"] = entry
        if (best_entry is None or entry["aggregate_frames_per_s"] >
                best_entry["aggregate_frames_per_s"]):
            best_entry = entry


def bench_batched_3x4096(jax, jnp, klt, out):
    """Config 4: all three datasets tracked CONCURRENTLY, 4096 features
    each, one batched kernel invocation per level per step (the
    one-device slice of the data-parallel config)."""
    from klt.parallel.batched_lk import track_sequences_batched

    cfg = klt.TrackingConfig(sequential_mode=True)
    t_frames = 10
    n = int(os.environ.get("KLT_BENCH_N4096", "4096"))  # CPU smoke
    seqs, xs, ys, vs = [], [], [], []
    for name, lo in (("images_provided", 0), ("images_traffic", 1),
                     ("images_laptops", 1)):
        fr = _load(klt, name, lo, lo + t_frames)
        # features seeded on the ORIGINAL frame (the padded seam would
        # otherwise attract fake corners), then pad to a 480x640 canvas
        fl = _seed(klt, fr[0], n, cfg)
        xs.append(fl.x)
        ys.append(fl.y)
        vs.append(fl.val)
        ph, pw = 480 - fr.shape[1], 640 - fr.shape[2]
        seqs.append(np.pad(fr, ((0, 0), (0, ph), (0, pw))))
    frames = np.stack(seqs)  # [3, T, 480, 640]
    x = jnp.asarray(np.stack(xs))
    y = jnp.asarray(np.stack(ys))
    v = jnp.asarray(np.stack(vs))
    fd = jax.device_put(frames)

    # reps folded into one device program so dispatch is not timed;
    # pyramid precompute self-selects like the flagship batched entry
    # (bit-exact toggle, both points measured).
    reps = 3
    psweep = tuple(int(s) for s in os.environ.get(
        "KLT_BENCH_PRE", "1,0").split(","))
    pre_saved = os.environ.get("KLT_PRECOMP_PYR")

    def _best_time(fn, *args):
        r = fn(*args)
        jax.block_until_ready(r)
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            r = fn(*args)
            jax.block_until_ready(r)
            best = min(best, (time.perf_counter() - t0) / reps)
        return best, r

    entry = None
    for pre in psweep:
        os.environ["KLT_PRECOMP_PYR"] = str(pre)

        @jax.jit
        def timed_run(fd, x, y, v):
            def body(i, acc):
                xs, ys, vs = track_sequences_batched(
                    fd, x + 1e-4 * i.astype(jnp.float32), y, v, cfg)
                return acc + xs[-1]
            return jax.lax.fori_loop(0, reps, body, jnp.zeros_like(x))

        dt, _ = _best_time(timed_run, fd, x, y, v)
        agg = 3 * (t_frames - 1) / dt
        if entry is None or agg > entry["aggregate_frames_per_s"]:
            r = track_sequences_batched(fd, x, y, v, cfg)
            entry = {
                "frames": t_frames,
                "precomp_pyramids": bool(pre),
                "aggregate_frames_per_s": round(agg, 1),
                "tracked_features_per_s": round(agg * n, 0),
                "final_live_features": [
                    int((np.asarray(r[2][-1][b]) >= 0).sum())
                    for b in range(3)],
            }
    out["batched_3seq_4096feat"] = entry

    # single-sequence 4096-feature latency (VERDICT r2 #4: the large-F
    # extraction scheme's single-stream number, traffic sequence)
    from klt.runtime.pipeline import track_sequence
    entry1 = None
    for pre in psweep:
        os.environ["KLT_PRECOMP_PYR"] = str(pre)

        @jax.jit
        def timed_run1(fr, x, y, v):
            def body(i, acc):
                xs, ys, vs = track_sequence(
                    fr, x + 1e-4 * i.astype(jnp.float32), y, v, cfg)
                return acc + xs[-1]
            return jax.lax.fori_loop(0, reps, body, jnp.zeros_like(x))

        dt1, _ = _best_time(timed_run1, fd[1], x[1], y[1], v[1])
        fps1 = (t_frames - 1) / dt1
        if entry1 is None or fps1 > entry1["frames_per_s"]:
            r1 = track_sequence(fd[1], x[1], y[1], v[1], cfg)
            entry1 = {
                "frames": t_frames,
                "precomp_pyramids": bool(pre),
                "frames_per_s": round(fps1, 1),
                "final_live_features": int(
                    (np.asarray(r1[2][-1]) >= 0).sum()),
            }
    out["single_traffic_4096feat"] = entry1
    if pre_saved is None:
        os.environ.pop("KLT_PRECOMP_PYR", None)
    else:
        os.environ["KLT_PRECOMP_PYR"] = pre_saved


def bench_slam_e2e(jax, jnp, klt, out):
    """Config 5: laptops front end (device scan + in-scan replacement)
    -> chains -> keyframes -> pose graph -> matrix-free Schur/CG
    bundle adjustment, over the FULL 1003-frame sequence.  Every stage
    reports compile and steady-state seconds separately."""
    from klt.runtime.pipeline import track_sequence_replace
    from klt.slam import (tracks_from_table, select_keyframes,
                              BAProblem, bundle_adjust_cg)
    from klt.slam.frontend import build_keyframe_pose_graph
    from klt.slam.pose_graph import optimize_pose_graph

    cfg = klt.TrackingConfig(sequential_mode=True)
    n_frames = int(os.environ.get("KLT_BENCH_SLAM_FRAMES", "1003"))
    n_feat = int(os.environ.get("KLT_BENCH_SLAM_FEAT", "1000"))
    frames = _load(klt, "images_laptops", 1, n_frames + 1)
    fl = _seed(klt, frames[0], n_feat, cfg)
    ft = klt.FeatureTable.create(n_frames, n_feat)
    ft.store_list(fl, 0)

    fd = jax.device_put(frames)
    t0 = time.perf_counter()
    xs, ys, vs = track_sequence_replace(
        fd, jnp.asarray(fl.x), jnp.asarray(fl.y), jnp.asarray(fl.val),
        cfg)
    jax.block_until_ready(vs)
    fe_compile_and_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    xs, ys, vs = track_sequence_replace(
        fd, jnp.asarray(fl.x), jnp.asarray(fl.y), jnp.asarray(fl.val),
        cfg)
    jax.block_until_ready(vs)
    fe_s = time.perf_counter() - t0
    xs, ys, vs = np.asarray(xs), np.asarray(ys), np.asarray(vs)
    ft.x[:, 1:] = xs.T
    ft.y[:, 1:] = ys.T
    ft.val[:, 1:] = vs.T

    tid, frame, u, v = tracks_from_table(ft.x, ft.y, ft.val,
                                         min_length=3)
    kfs = select_keyframes(ft.val, overlap_thresh=0.8)
    kf_set = {int(f): i for i, f in enumerate(kfs)}
    keep = np.isin(frame, kfs)
    tid, frame, u, v = tid[keep], frame[keep], u[keep], v[keep]
    ids, counts = np.unique(tid, return_counts=True)
    keep = np.isin(tid, ids[counts >= 2])
    tid, frame, u, v = tid[keep], frame[keep], u[keep], v[keep]
    if len(kfs) < 2 or tid.size == 0:
        out["slam_frontend_ba"] = {
            "skipped": f"degenerate problem ({len(kfs)} keyframes, "
                       f"{tid.size} observations) — too few frames"}
        return
    _, tid = np.unique(tid, return_inverse=True)
    lm_idx = tid.astype(np.int32)
    cam_idx = np.asarray([kf_set[int(f)] for f in frame], np.int32)
    n_pose, n_lm = len(kfs), int(lm_idx.max()) + 1
    h, w = frames.shape[1:3]
    fx = fy = 0.9 * w
    cx, cy = w / 2.0, h / 2.0
    lm0 = np.zeros((n_lm, 3), np.float32)
    first = np.full(n_lm, -1, np.int64)
    ids_f, idx_f = np.unique(lm_idx, return_index=True)
    first[ids_f] = idx_f
    lm0[:, 0] = (u[first] - cx) / fx
    lm0[:, 1] = (v[first] - cy) / fy
    lm0[:, 2] = 1.0
    # front end -> POSE GRAPH -> BA: relative poses from tiny two-pose
    # BAs on shared tracks, chained through the SE(3) pose graph.
    # Graph construction (host loop over pair BAs, includes the single
    # pair-BA compile) is timed apart from graph optimization, and the
    # optimizer is run twice so compile and steady-state are separate.
    t_pg0 = time.perf_counter()
    pg = build_keyframe_pose_graph(lm_idx, cam_idx, u, v, n_pose,
                                   fx, fy, cx, cy)
    pg_build_compile_s = time.perf_counter() - t_pg0
    t_pg0 = time.perf_counter()
    pg = build_keyframe_pose_graph(lm_idx, cam_idx, u, v, n_pose,
                                   fx, fy, cx, cy)
    pg_build_s = time.perf_counter() - t_pg0
    t0 = time.perf_counter()
    R_init, t_init, pg_costs = optimize_pose_graph(pg, iterations=10)
    jax.block_until_ready(pg_costs)
    pg_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    R_init, t_init, pg_costs = optimize_pose_graph(pg, iterations=10)
    jax.block_until_ready(pg_costs)
    pg_steady_s = time.perf_counter() - t0
    pg_costs = np.asarray(pg_costs)

    # The chained init is nearly graph-consistent by construction, so
    # the absolute cost barely moves; to show the optimizer does real
    # work, perturb the init and verify it recovers to the same cost.
    import dataclasses as _dc
    from klt.slam.geometry import so3_exp
    rng = np.random.RandomState(0)
    dR = so3_exp(jnp.asarray(
        0.05 * rng.standard_normal((int(n_pose), 3)).astype(np.float32)))
    pg_pert = _dc.replace(
        pg, R=jnp.einsum("pij,pjk->pik", pg.R, dR),
        t=pg.t + jnp.asarray(
            0.05 * rng.standard_normal((int(n_pose), 3)).astype(np.float32)))
    _, _, pert_costs = optimize_pose_graph(pg_pert, iterations=10)
    pert_costs = np.asarray(pert_costs)

    prob = BAProblem(
        R=jnp.asarray(R_init),
        t=jnp.asarray(t_init),
        landmarks=jnp.asarray(lm0),
        cam_idx=jnp.asarray(cam_idx), lm_idx=jnp.asarray(lm_idx),
        uv=jnp.asarray(np.stack([u, v], -1).astype(np.float32)),
        weight=jnp.ones(len(cam_idx), jnp.float32),
        fx=fx, fy=fy, cx=cx, cy=cy)
    # Huber IRLS (delta 2 px) + reprojection-gated pruning rounds
    # (VERDICT r4 item 6): drifted front-end tracks are gated OUT of
    # the problem between LM rounds instead of merely down-weighted,
    # so the final solve is supported by a clean association set.
    from klt.slam import bundle_adjust_gated
    t0 = time.perf_counter()
    R, t, lm, costs, active = bundle_adjust_gated(
        prob, rounds=3, iterations=17, robust_delta=2.0, gate_px=2.0)
    jax.block_until_ready(costs)
    ba_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    R, t, lm, costs, active = bundle_adjust_gated(
        prob, rounds=3, iterations=17, robust_delta=2.0, gate_px=2.0)
    jax.block_until_ready(costs)
    ba_steady_s = time.perf_counter() - t0
    costs = np.asarray(costs)
    rms = lambda i: round(float(np.sqrt(
        costs[i] / max(len(cam_idx), 1))), 3)
    # unweighted per-observation residuals at the solution.
    # outlier_frac = residuals beyond delta among the observations the
    # BA is actually fed (the gated-in set); gated_out_frac reports
    # how much the gating pruned — both are needed to read the result
    # honestly (a tiny outlier_frac over a tiny surviving set would
    # mean the front end, not the BA, is broken).
    from klt.slam.ba import _residual_norms
    rn = np.asarray(_residual_norms(R, t, lm, prob))
    inl = active & (rn <= 2.0)
    inlier_rms = round(float(np.sqrt(np.mean(rn[inl] ** 2)))
                       if inl.any() else -1.0, 3)
    outlier_frac = round(float((rn[active] > 2.0).mean())
                         if active.any() else 1.0, 4)
    gated_out_frac = round(float(1.0 - active.mean()), 4)
    out["slam_frontend_ba"] = {
        "frontend_frames_per_s": round((n_frames - 1) / fe_s, 1),
        "frontend_compile_plus_run_s": round(fe_compile_and_run, 2),
        "frames": n_frames, "features": n_feat,
        "keyframes": int(n_pose), "landmarks": int(n_lm),
        "observations": int(len(cam_idx)),
        "pose_graph": {
            "build_s": round(pg_build_s, 2),
            "build_compile_s": round(pg_build_compile_s, 2),
            "compile_s": round(pg_compile_s, 2),
            "steady_s": round(pg_steady_s, 3),
            "cost": [round(float(pg_costs[i]), 5) for i in (0, -1)],
            "perturbed_recovery_cost": [
                round(float(pert_costs[i]), 5) for i in (0, -1)],
        },
        "ba": {
            "compile_s": round(ba_compile_s, 2),
            "steady_s": round(ba_steady_s, 2),
            "iterations": 50,
            "robust_delta_px": 2.0,
            # robust (Huber-weighted) cost curve; the contract number
            # is the UNWEIGHTED inlier RMS at the solution
            "reproj_rms_px": [rms(0), rms(len(costs) // 2), rms(-1)],
            "inlier_rms_px": inlier_rms,
            "outlier_frac": outlier_frac,
            "gated_out_frac": gated_out_frac,
            "active_observations": int(active.sum()),
        },
    }


def main():
    import jax
    from klt.utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    import jax.numpy as jnp
    import klt

    klt.set_verbosity(0)
    cfg = klt.TrackingConfig(sequential_mode=True)

    result = {
        "metric": "track_frames_per_s (images_provided, 150 feat, "
                  "2-level pyramid, 1 device)",
        "unit": "frames/s",
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "configs": {},
    }
    bench_flagship(jax, jnp, klt, cfg, result)

    extras = result["configs"]
    t_start = time.perf_counter()
    budget = float(os.environ.get("KLT_BENCH_BUDGET_S", "1500"))
    for fn in (bench_flagship_batched, bench_traffic_replace,
               bench_laptops_affine, bench_laptops_affine_batched,
               bench_batched_3x4096, bench_slam_e2e):
        if time.perf_counter() - t_start > budget:
            extras[fn.__name__] = {"skipped": "bench time budget"}
            continue
        fn(jax, jnp, klt, extras)

    _emit(result)


_CONTRACT_KEYS = (
    "frames_per_s", "aggregate_frames_per_s", "vs_baseline_fps",
    "vs_measured_cpu_baseline", "status_agreement", "within_half_px",
    "within_half_px_first50", "drift_px_median", "drift_px_p99",
    "same_detection_frac", "within_half_px_same_detection",
    "drift_px_p99_same_detection",
    "lane0_status_agreement", "lane0_drift_px_vs_cpu_golden",
    "status_agreement_vs_exact", "within_half_px_vs_exact",
    "tracked_features_per_s", "contract_ok", "outlier_frac",
    "gated_out_frac", "tier", "final_live_features", "frames", "batch",
    "error", "skipped",
)


def _emit(result):
    """Truncation-proof output: the full detail
    goes to BENCH_DETAIL.md next to this file; stdout carries ONE
    COMPACT json line holding the headline plus every per-config
    contract number, so a tail capture can never lose them."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        with open(os.path.join(here, "BENCH_DETAIL.md"), "w") as f:
            f.write("# BENCH detail (full per-config output)\n\n"
                    "Written by bench.py; the driver-captured line is "
                    "the compact contract summary.\n\n```json\n")
            json.dump(result, f, indent=1)
            f.write("\n```\n")
    except OSError:
        pass

    compact = {k: result[k] for k in
               ("metric", "value", "unit", "vs_baseline", "device",
                "drift_px_vs_cpu_golden", "status_agreement")
               if k in result}
    compact["configs"] = {}
    for name, entry in result["configs"].items():
        if not isinstance(entry, dict):
            compact["configs"][name] = entry
            continue
        c = {k: entry[k] for k in _CONTRACT_KEYS if k in entry}
        # one-level nesting for composite entries (slam)
        for k, v in entry.items():
            if isinstance(v, dict):
                sub = {kk: vv for kk, vv in v.items()
                       if kk in _CONTRACT_KEYS or
                       kk in ("build_s", "steady_s", "compile_s",
                              "reproj_rms_px", "inlier_rms_px",
                              "frontend_frames_per_s")}
                if sub:
                    c[k] = sub
        if "frontend_frames_per_s" in entry:
            c["frontend_frames_per_s"] = entry["frontend_frames_per_s"]
        if c:
            compact["configs"][name] = c
    print(json.dumps(compact))


if __name__ == "__main__":
    main()
