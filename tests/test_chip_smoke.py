"""chip_smoke.py's phases at tiny sizes on the CPU, plus the script's
refusal to run without a GPU and the compile-cache path rule."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("which", ["flagship", "affine"])
def test_phase_lk_kernel(which):
    cfg = cs.flagship_cfg() if which == "flagship" else cs.affine_cfg()
    out = cs.phase_lk_kernel(120, 160, 40, cfg, interpret=True)
    assert sorted(out) == list(range(cfg.n_pyramid_levels))
    for d in out.values():
        assert d["status_agreement"] >= cs.MIN_STATUS_AGREEMENT
        assert d["drift_px"] <= cs.DRIFT_PX


def test_phase_single_stream():
    out = cs.phase_single_stream(120, 160, 5, 40)
    assert out["median_err_px"] <= cs.GT_MEDIAN_PX
    assert out["ref_status_agreement"] >= 0.99


def test_phase_batched():
    out = cs.phase_batched(3, 120, 160, 4, 30)
    assert out["bit_identical_sequences"] == "3/3"


def test_phase_replace_then_ba():
    rep = cs.phase_replace(120, 160, 8, 40, 3)
    assert rep["exact_vs_cpu_bit_equal_frac"] == 1.0
    ba = cs.phase_ba(rep["table"], 120, 160)
    assert ba["cost_last"] < ba["cost_first"]


def test_phase_affine():
    out = cs.phase_affine(240, 320, 4, 100)
    assert out["vs_highest_drift_px"] == 0.0
    assert out["alive_fraction"] > 0.5


def test_phase_four_devices():
    """The four-card phase on four virtual CPU devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    out = cs.phase_four_devices(4, 4, 120, 160, 4, 30)
    assert out["shard_devices"] == 4
    assert out["ba_cost_rel_diff"] <= 1e-3


def test_step_errors_use_tracked_steps_only():
    motion = np.array([[0, 0], [1, 0], [1, 2]], np.float32)
    x0 = np.array([10, 20], np.float32)
    y0 = np.array([10, 20], np.float32)
    v0 = np.array([5, 5], np.int32)
    xs = np.array([[11.1, 21.0], [11.0, 30.0]], np.float32)
    ys = np.array([[10.0, 20.0], [12.0, 30.0]], np.float32)
    vs = np.array([[0, -4], [0, 7]], np.int32)  # lost, then replaced
    err = cs.step_errors(x0, y0, v0, xs, ys, vs, motion)
    np.testing.assert_allclose(err, [0.1, 0.1], atol=1e-5)


def test_refuses_to_run_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    with pytest.raises(json.JSONDecodeError):
        json.loads(r.stdout.strip().splitlines()[-1] if r.stdout.strip()
                   else "")


def test_compile_cache_path_rule():
    from klt.utils import compile_cache as cc
    assert cc.cache_dir({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None
    assert cc.cache_dir({}) == cc.CHECKOUT_CACHE
    assert os.path.dirname(cc.CHECKOUT_CACHE) == ROOT
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert os.path.basename(cc.CHECKOUT_CACHE) + "/" in ignored
