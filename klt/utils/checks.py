"""Debug-mode runtime checks (the reference's assert set, §4.3).

The C library compiles asserts out with -DNDEBUG (src/V1/Makefile:9);
here the equivalent guards are jax.debug/chex checks gated on
KLT_DEBUG=1 so the production path pays nothing.  Covered asserts:

* in-bounds interpolation coordinates (src/V1/trackFeatures.c:51)
* image-size compatibility between convolution operands
  (src/V1/convolve.c:46-47)
* pyramid level dimensions (src/V1/pyramid.c:105-106)
* finite feature positions after tracking
"""

from __future__ import annotations

import os


def debug_enabled() -> bool:
    return os.environ.get("KLT_DEBUG", "0") == "1"


def check_in_bounds(x, y, ncols: int, nrows: int, what: str = "coords"):
    """Device-side in-bounds check (active only in debug mode): emits a
    KLT warning via host callback when violated."""
    if not debug_enabled():
        return
    import chex
    import jax.numpy as jnp
    import jax.debug as jdbg
    chex.assert_equal_shape((x, y))
    bad = jnp.any((x < 0) | (x > ncols - 1) | (y < 0) | (y > nrows - 1))
    jdbg.callback(_warn_if, bad, what)


def _warn_if(bad, what):
    if bool(bad):
        from ..errors import klt_warning
        klt_warning(f"debug check failed: {what} out of bounds")


def check_same_shape(a, b, what: str = "images"):
    if not debug_enabled():
        return
    import chex
    chex.assert_equal_shape((a, b), custom_message=f"{what} mismatch")


def check_finite(arr, what: str = "values"):
    if not debug_enabled():
        return
    import jax.numpy as jnp
    import jax.debug as jdbg
    jdbg.callback(_warn_if, jnp.any(~jnp.isfinite(arr)), what)
