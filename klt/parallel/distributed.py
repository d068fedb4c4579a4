"""Multi-host runtime helpers.

The reference is single-process/single-device (SURVEY.md section 2:
"Distributed communication backend: none exists").  These helpers are
the from-scratch equivalent, building on mesh.initialize_multihost:
a global mesh whose `data` axis spans all chips (ICI within a slice,
DCN across hosts) and the per-host batch-slicing contract.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import initialize_multihost  # re-export  # noqa: F401


def global_data_mesh(feat: int = 1) -> Mesh:
    """Mesh over every addressable chip: ('data', 'feat').

    The data axis carries independent sequences (no collectives on the
    tracking hot path); the feat axis optionally splits very large
    feature sets.  Bundle adjustment's psum reductions ride the same
    mesh (ICI within a slice, DCN across hosts).
    """
    devs = np.asarray(jax.devices())
    n = devs.size
    if n % feat != 0:
        raise ValueError(f"{n} devices not divisible by feat={feat}")
    return Mesh(devs.reshape(n // feat, feat), ("data", "feat"))


def process_local_batch(b_global: int) -> tuple[int, int]:
    """(local batch size, offset) for this host's shard of a global
    batch — the host-side data-loading contract for multi-host runs."""
    n_proc = jax.process_count()
    if b_global % n_proc != 0:
        raise ValueError(f"global batch {b_global} not divisible by "
                         f"{n_proc} processes")
    local = b_global // n_proc
    return local, jax.process_index() * local
