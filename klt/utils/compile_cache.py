"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting and wins:
nothing is set in code.  Otherwise the cache lives at a fixed path inside
the checkout (`.jax_cache/`, listed in .gitignore), so repeated runs from
the same checkout find their compiled programs again.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir(environ=os.environ) -> str | None:
    """The directory to set in code, or None when the environment
    already names one."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT_CACHE


def configure_compile_cache() -> None:
    """Point JAX's persistent compilation cache at cache_dir()."""
    path = cache_dir()
    if path is not None:
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
