"""Pallas kernels for NVIDIA GPUs, written for the Triton route.

Each kernel has a plain-JAX oracle in klt/ops, which is also the path on
every other backend.  The dispatchers choose a kernel from the backend
alone; tests run the kernels on the CPU through the wrappers' explicit
`interpret` argument.
"""

import jax


def lk_kernel_enabled() -> bool:
    """True when the LK level kernel (pallas/lk.py) serves track_level:
    the default backend is an NVIDIA GPU."""
    return jax.default_backend() == "gpu"
