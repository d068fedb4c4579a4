"""Tiny-shape smoke test for every bench_* function.

Runs each benchmark end to end with 2-3 frames / few features on the
CPU backend, asserting (a) no bench function records an "error" entry
(the round-4 NameError class of bug), and (b) every KLT_* knob a
bench touches is restored afterwards (the round-4 unroll-leak class).
The numbers themselves are meaningless here; only the control flow and
env hygiene are under test.
"""

import importlib
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import klt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bench  # noqa: E402

TINY_ENV = {
    "KLT_BENCH_REPS": "1",
    "KLT_BENCH_B": "2",
    "KLT_BENCH_PRE": "1",
    "KLT_BENCH_N4096": "8",
    "KLT_BENCH_AFFINE_FRAMES": "2",
    "KLT_BENCH_AFFINE_FEAT": "32",
    "KLT_BENCH_AFFB_FRAMES": "3",
    "KLT_BENCH_AFFB_FEAT": "32",
    "KLT_BENCH_AFFB_B": "2",
    "KLT_BENCH_TRAFFIC_FRAMES": "3",
    "KLT_BENCH_TRAFFIC_FEAT": "32",
    "KLT_BENCH_SLAM_FRAMES": "80",
    "KLT_BENCH_SLAM_FEAT": "96",
}

# every knob the bench functions may set internally and must restore
GUARDED_KNOBS = ("KLT_PRECOMP_PYR", "KLT_SCAN_UNROLL")


@pytest.fixture()
def tiny_env():
    saved = {k: os.environ.get(k) for k in
             list(TINY_ENV) + list(GUARDED_KNOBS)}
    os.environ.update(TINY_ENV)
    for k in GUARDED_KNOBS:
        os.environ.pop(k, None)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _assert_clean(out):
    for name, entry in out.items():
        if isinstance(entry, dict):
            assert "error" not in entry, f"{name}: {entry['error']}"
    for k in GUARDED_KNOBS:
        assert os.environ.get(k) is None, \
            f"bench leaked {k}={os.environ[k]}"


def _dataset_or_skip(name):
    if not os.path.isdir(os.path.join(bench.DATA, name)):
        pytest.skip(f"{name} dataset not available")


def test_bench_flagship_smoke(tiny_env):
    _dataset_or_skip("images_provided")
    klt.set_verbosity(0)
    result = {"configs": {}}
    cfg = klt.TrackingConfig(sequential_mode=True)
    bench.bench_flagship(jax, jnp, klt, cfg, result)
    assert result.get("value", 0) > 0
    _assert_clean(result["configs"])


def test_bench_flagship_batched_smoke(tiny_env):
    _dataset_or_skip("images_provided")
    klt.set_verbosity(0)
    out = {}
    bench.bench_flagship_batched(jax, jnp, klt, out)
    assert "flagship_batched_throughput" in out
    _assert_clean(out)


def test_bench_traffic_replace_smoke(tiny_env):
    _dataset_or_skip("images_traffic")
    klt.set_verbosity(0)
    out = {}
    bench.bench_traffic_replace(jax, jnp, klt, out)
    assert "traffic_500feat_replace_551f" in out
    assert "traffic_500feat_replace_551f_fast" in out
    assert "traffic_500feat_replace_551f_bf16" in out
    # the bf16 probe row must carry the one-place contract verdict
    assert "contract_ok" in out["traffic_500feat_replace_551f_bf16"]
    _assert_clean(out)


def test_bench_laptops_affine_smoke(tiny_env):
    _dataset_or_skip("images_laptops")
    klt.set_verbosity(0)
    out = {}
    bench.bench_laptops_affine(jax, jnp, klt, out)
    assert "laptops_2000feat_affine_4level" in out
    _assert_clean(out)


def test_bench_laptops_affine_batched_smoke(tiny_env):
    _dataset_or_skip("images_laptops")
    klt.set_verbosity(0)
    out = {}
    bench.bench_laptops_affine_batched(jax, jnp, klt, out)
    assert "laptops_affine_batched_b2" in out
    _assert_clean(out)


def test_bench_batched_3x4096_smoke(tiny_env):
    for d in ("images_provided", "images_traffic", "images_laptops"):
        _dataset_or_skip(d)
    klt.set_verbosity(0)
    out = {}
    bench.bench_batched_3x4096(jax, jnp, klt, out)
    assert "batched_3seq_4096feat" in out
    assert "single_traffic_4096feat" in out
    _assert_clean(out)


@pytest.mark.slow
def test_bench_slam_smoke(tiny_env):
    _dataset_or_skip("images_laptops")
    klt.set_verbosity(0)
    out = {}
    bench.bench_slam_e2e(jax, jnp, klt, out)
    assert "slam_frontend_ba" in out
    _assert_clean(out)


def test_contract_gate_single_place():
    """The one-place gate: rows without parity evidence fail closed;
    in-contract rows pass; each violation flips it."""
    assert not bench.contract_ok({})
    good = {"lane0_status_agreement": 1.0,
            "lane0_drift_px_vs_cpu_golden": 0.13}
    assert bench.contract_ok(good)
    assert not bench.contract_ok(
        dict(good, lane0_drift_px_vs_cpu_golden=0.51))
    assert not bench.contract_ok(dict(good, lane0_status_agreement=0.9))
    tr = {"within_half_px": 0.99,
          "within_half_px_same_detection": 0.999}
    assert bench.contract_ok(tr)
    assert not bench.contract_ok(dict(tr, within_half_px=0.51))
    ex = {"status_agreement_vs_exact": 1.0,
          "within_half_px_vs_exact": 1.0}
    assert bench.contract_ok(ex)
    assert not bench.contract_ok(
        dict(ex, within_half_px_vs_exact=0.9))
