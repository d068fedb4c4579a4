"""klt — KLT feature tracking / SLAM front-end engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the pyramidal Kanade-Lucas-
Tomasi tracker (reference capability set:
FatimaSohailll/KLT-Feature-Tracker-Acceleration-GPUs): min-eigenvalue
corner selection, separable Gaussian pyramids, batched iterative
Lucas-Kanade tracking with per-feature masks, lost-feature replacement,
affine consistency checking, and bit-compatible feature-table I/O —
extended with multi-chip sharded batch tracking and a tracking-to-mapping
SLAM pipeline.

Quick start::

    import klt

    cfg = klt.TrackingConfig(sequential_mode=True)
    tracker = klt.KLTracker(cfg)
    fl = klt.FeatureList.create(150)
    tracker.select_good_features(img0, fl)     # uint8 [H, W] numpy
    tracker.track_features(img0, img1, fl)
"""

from .config import (TrackingConfig, TRACKED, NOT_FOUND, SMALL_DET,
                     MAX_ITERATIONS, OOB, LARGE_RESIDUE)
from .features import FeatureList, FeatureHistory, FeatureTable
from .runtime.tracker import KLTracker, set_verbosity
from .io.pnm import read_pgm, write_pgm, read_ppm, write_ppm
from .io.features_io import (write_feature_list, write_feature_history,
                             write_feature_table, read_feature_list,
                             read_feature_history, read_feature_table)
from .utils.viz import feature_overlay, write_feature_list_ppm

__version__ = "0.1.0"

__all__ = [
    "TrackingConfig", "KLTracker", "FeatureList", "FeatureHistory",
    "FeatureTable", "set_verbosity",
    "TRACKED", "NOT_FOUND", "SMALL_DET", "MAX_ITERATIONS", "OOB",
    "LARGE_RESIDUE",
    "read_pgm", "write_pgm", "read_ppm", "write_ppm",
    "write_feature_list", "write_feature_history", "write_feature_table",
    "read_feature_list", "read_feature_history", "read_feature_table",
    "feature_overlay", "write_feature_list_ppm",
]
