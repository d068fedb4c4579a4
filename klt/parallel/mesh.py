"""Device-mesh construction.

The reference has no distributed backend (SURVEY.md §2: single process,
single device).  This framework scales with a named `jax.sharding.Mesh`:
sequences batch across the `data` axis, the feature axis shards across
`feat` for very large feature counts, and XLA inserts the collectives.
Multi-host runs initialize `jax.distributed` and lay the mesh over
ICI-first axis order.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def default_device_count() -> int:
    return len(jax.devices())


def make_mesh(axis_sizes: dict[str, int] | None = None,
              devices=None) -> Mesh:
    """Build a named mesh.

    axis_sizes maps axis name -> size; a single -1 entry absorbs the
    remaining devices.  Default: all devices on one 'data' axis.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = {"data": n}

    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n}")
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, tuple(names))


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Bring up the multi-host runtime (DCN) when running across hosts.
    No-op in single-process runs."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
