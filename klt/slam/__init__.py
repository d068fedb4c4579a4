"""SLAM front-end extension (north-star scope beyond the reference).

The reference library stops at per-frame feature tracks
(KLT_FeatureTable, src/V1/klt.h:108-122).  This package turns those
tracks into a minimal SLAM pipeline:

* chains    — feature-table -> observation chains, keyframe selection
* geometry  — batched SE(3) / pinhole camera ops (pure jnp)
* ba        — sparse bundle adjustment via Schur complement, with the
              observation axis sharded over a device mesh (psum
              collectives inside shard_map)
* pose_graph — SE(3) pose-graph optimization over relative-pose edges,
              edge axis sharded the same way
"""

from .chains import tracks_from_table, select_keyframes
from .geometry import se3_exp, se3_apply, project
from .ba import (BAProblem, bundle_adjust, bundle_adjust_cg,
                 bundle_adjust_gated)
from .pose_graph import PoseGraph, optimize_pose_graph

__all__ = [
    "tracks_from_table", "select_keyframes",
    "se3_exp", "se3_apply", "project",
    "BAProblem", "bundle_adjust", "bundle_adjust_cg",
    "bundle_adjust_gated",
    "PoseGraph", "optimize_pose_graph",
]
