"""Test configuration: a virtual 8-device CPU mesh by default.

Must run before jax is imported anywhere.  JAX_PLATFORMS defaults to
cpu.  Tests that need an NVIDIA GPU carry the `gpu` marker and skip
through the `gpu_device` fixture where there is none; run them on the
card with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from klt.utils.compile_cache import configure_compile_cache  # noqa: E402

# The suite is compile-dominated; the persistent cache makes every run
# after the first warm (keys hash the HLO, so code changes invalidate
# exactly the programs they touch).
configure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REF_DATA = "/root/reference/data"
REF_GOLDEN = "/root/reference/src/V1/feat"


def fixture_path(name: str) -> str:
    return os.path.join(FIXTURES, name)


def load_f32(name: str, shape) -> np.ndarray:
    return np.fromfile(fixture_path(name), dtype=np.float32).reshape(shape)


def load_xyv(name: str):
    rec = np.fromfile(fixture_path(name), dtype=np.float32).reshape(-1, 3)
    return rec[:, 0].copy(), rec[:, 1].copy(), rec[:, 2].view(np.int32).copy()


@pytest.fixture(scope="session")
def provided_frames():
    """The 10-frame images_provided sequence (uint8 [240, 320] each)."""
    from klt.io.pnm import read_pgm
    d = os.path.join(REF_DATA, "images_provided")
    if not os.path.isdir(d):
        pytest.skip("images_provided dataset not available")
    return [read_pgm(os.path.join(d, f"img{i}.pgm")) for i in range(10)]


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run tests marked slow (full fuzz matrices)")


def pytest_collection_modifyitems(config, items):
    if (config.getoption("--runslow") or
            os.environ.get("KLT_SLOW_TESTS") == "1"):
        return
    skip = pytest.mark.skip(reason="slow: use --runslow or "
                            "KLT_SLOW_TESTS=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture()
def gpu_device():
    """The first NVIDIA GPU; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU")
    return devs[0]


@pytest.fixture(scope="session")
def synthetic_frames():
    """(frames uint8 [10, 120, 160], motion f32 [10, 2]) from the seeded
    generator: a known sub-pixel translation per frame."""
    from klt.io.synthetic import translated_sequence
    return translated_sequence(10, 120, 160, seed=7)


@pytest.fixture(autouse=True)
def _quiet():
    import klt
    klt.set_verbosity(0)
    yield
