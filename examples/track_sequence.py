"""Example driver: select-and-track over a PGM sequence.

The klt equivalent of the reference's example3
(src/V1/example3.c / src/V3/example3GPU.c): selects features on the
first frame, tracks through the sequence in sequential mode, writes
feature-table files and PPM overlays.

Usage:
    python examples/track_sequence.py [dataset] [nFeatures] [nFrames]
                                      [--replace] [--affine] [--out DIR]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import klt  # noqa: E402
from klt.io.dataset import find_dataset, ImageSequence  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", nargs="?", default="images_provided")
    ap.add_argument("n_features", nargs="?", type=int, default=150)
    ap.add_argument("n_frames", nargs="?", type=int, default=10)
    ap.add_argument("--replace", action="store_true",
                    help="replace lost features every frame")
    ap.add_argument("--affine", type=int, default=-1,
                    help="affine consistency mode (-1/0/1/2)")
    ap.add_argument("--out", default="feat")
    ap.add_argument("--overlays", action="store_true",
                    help="write per-frame PPM overlays")
    args = ap.parse_args()

    path = find_dataset(args.dataset)
    if path is None:
        sys.exit(f"dataset '{args.dataset}' not found")
    seq = ImageSequence(path)
    n_frames = min(args.n_frames, len(seq))
    os.makedirs(args.out, exist_ok=True)

    cfg = klt.TrackingConfig(sequential_mode=True,
                             affine_consistency_check=args.affine)
    tracker = klt.KLTracker(cfg)
    fl = klt.FeatureList.create(args.n_features)
    ft = klt.FeatureTable.create(n_frames, args.n_features)

    img1 = seq[0]
    tracker.select_good_features(img1, fl)
    ft.store_list(fl, 0)
    if args.overlays:
        klt.write_feature_list_ppm(fl, img1, f"{args.out}/feat1.ppm")

    total = 0.0
    for i in range(1, n_frames):
        img2 = seq[i]
        t0 = time.perf_counter()
        tracker.track_features(img1, img2, fl)
        total += time.perf_counter() - t0
        if args.replace:
            tracker.replace_lost_features(img2, fl)
        ft.store_list(fl, i - 1)
        if args.overlays:
            klt.write_feature_list_ppm(fl, img2, f"{args.out}/feat{i}.ppm")
        img1 = img2

    klt.write_feature_table(ft, f"{args.out}/features.txt", "%5.1f")
    klt.write_feature_table(ft, f"{args.out}/features.ft")
    print(f"tracked {n_frames - 1} frame pairs in {total:.3f}s "
          f"({(n_frames - 1) / total:.1f} fps incl. host loop); "
          f"{fl.count_remaining()} features remaining")


if __name__ == "__main__":
    main()
