"""Kernel taps and widths vs the reference impulse-response oracles."""

import numpy as np
import pytest

from klt.kernels import gaussian_kernels, kernel_widths
from conftest import load_f32


@pytest.mark.parametrize("sigma,tag", [(0.7, "0p7"), (1.0, "1p0"),
                                       (3.6, "3p6")])
def test_smooth_impulse_matches_oracle(sigma, tag):
    """Smoothing a centered delta = outer(gauss, gauss)."""
    oracle = load_f32(f"delta_smooth_s{tag}.f32", (64, 64))
    g, _ = gaussian_kernels(sigma)
    r = len(g) // 2
    c = 32
    expect = np.outer(g, g)
    got = oracle[c - r:c + r + 1, c - r:c + r + 1]
    np.testing.assert_allclose(got, expect, atol=1e-7)
    # everything outside the support is zero
    masked = oracle.copy()
    masked[c - r:c + r + 1, c - r:c + r + 1] = 0
    assert np.all(masked == 0)


@pytest.mark.parametrize("sigma,tag", [(0.7, "0p7"), (1.0, "1p0"),
                                       (3.6, "3p6")])
def test_gradient_impulse_matches_oracle(sigma, tag):
    """gradx impulse = outer(gauss_vert, deriv_horiz) with the reference's
    reversed-tap (true convolution) orientation."""
    oracle = load_f32(f"delta_gradx_s{tag}.f32", (64, 64))
    g, d = gaussian_kernels(sigma)
    rg, rd = len(g) // 2, len(d) // 2
    c = 32
    # impulse response of convolution (reversed-tap correlation) is the
    # taps in natural order
    expect = np.outer(g, d)
    got = oracle[c - rg:c + rg + 1, c - rd:c + rd + 1]
    np.testing.assert_allclose(got, expect, atol=1e-7)


def test_kernel_widths():
    """Widths from the 1% tail rule for the default sigmas."""
    assert kernel_widths(0.7) == (5, 5)
    gw, dw = kernel_widths(1.0)
    assert gw % 2 == 1 and dw % 2 == 1
    assert kernel_widths(3.6)[0] == 21  # drives border=24 for defaults


def test_gauss_normalized():
    for sigma in (0.7, 1.0, 3.6, 2.5):
        g, d = gaussian_kernels(sigma)
        assert abs(g.sum() - 1.0) < 1e-6
        hw = len(d) // 2
        moment = -sum(i * d[i + hw] for i in range(-hw, hw + 1))
        assert abs(moment - 1.0) < 1e-5


def test_sigma_too_large_raises():
    with np.testing.assert_raises(ValueError):
        gaussian_kernels(25.0)


def test_div_cr_correctly_rounded():
    """ops.lk_exact._div_cr must produce the correctly-rounded f32
    quotient (= what C scalar division gives).  On CPU the hardware
    divide is already correctly rounded, so this doubles as a
    no-perturbation regression; on a device with a faithfully-but-not-
    correctly-rounded divide it is the fix."""
    import jax
    import jax.numpy as jnp
    from klt.ops.lk_exact import _div_cr

    rng = np.random.RandomState(5)
    a = (rng.uniform(-1e6, 1e6, 20000)).astype(np.float32)
    b = (rng.uniform(0.01, 1e5, 20000) *
         np.sign(rng.randn(20000))).astype(np.float32)
    got = np.asarray(jax.jit(_div_cr)(jnp.asarray(a), jnp.asarray(b)))
    ref = (a.astype(np.float64) / b.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, ref)
    # exact quotients stay exact
    q = np.asarray(jax.jit(_div_cr)(jnp.float32(3.0), jnp.float32(4.0)))
    assert q == np.float32(0.75)
