"""Feature-file and PNM I/O: byte-compatibility with the reference."""

import os

import numpy as np
import pytest

import klt
from klt.features import FeatureList, FeatureHistory, FeatureTable
from klt.io.features_io import (write_feature_table, read_feature_table,
                                    write_feature_list, read_feature_list,
                                    write_feature_history,
                                    read_feature_history)
from klt.io.pnm import read_pgm, write_pgm, read_ppm, write_ppm
from conftest import REF_GOLDEN


@pytest.mark.skipif(not os.path.isdir(REF_GOLDEN),
                    reason="reference goldens unavailable")
def test_table_text_bytes_match_reference(tmp_path):
    """Read the golden binary table, write text — must equal the golden
    text file byte-for-byte (same printf semantics)."""
    ft = read_feature_table(os.path.join(REF_GOLDEN, "features2.ft"))
    out = tmp_path / "features2.txt"
    write_feature_table(ft, str(out), "%5.1f")
    got = out.read_bytes()
    want = open(os.path.join(REF_GOLDEN, "features2.txt"), "rb").read()
    assert got == want


@pytest.mark.skipif(not os.path.isdir(REF_GOLDEN),
                    reason="reference goldens unavailable")
def test_table_binary_bytes_match_reference(tmp_path):
    ft = read_feature_table(os.path.join(REF_GOLDEN, "features2.ft"))
    out = tmp_path / "features2.ft"
    write_feature_table(ft, str(out))
    got = out.read_bytes()
    want = open(os.path.join(REF_GOLDEN, "features2.ft"), "rb").read()
    assert got == want


def test_table_text_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    ft = FeatureTable.create(4, 7)
    ft.x[:] = rng.rand(7, 4).astype(np.float32) * 300
    ft.y[:] = rng.rand(7, 4).astype(np.float32) * 200
    ft.val[:] = rng.randint(-5, 100, (7, 4))
    p = tmp_path / "t.txt"
    write_feature_table(ft, str(p), "%7.3f")
    back = read_feature_table(str(p))
    np.testing.assert_allclose(back.x, ft.x, atol=1e-3)
    np.testing.assert_allclose(back.y, ft.y, atol=1e-3)
    np.testing.assert_array_equal(back.val, ft.val)


def test_list_and_history_roundtrip(tmp_path):
    fl = FeatureList.create(5)
    fl.x[:] = [1.5, 2.25, -1, 3.75, 100.0]
    fl.y[:] = [9.5, 8.25, -1, 7.125, 200.0]
    fl.val[:] = [0, 10, -4, 0, 523]
    for fmt in (None, "%5.1f", "%3d"):
        p = tmp_path / f"l{fmt or 'bin'}.dat"
        write_feature_list(fl, str(p), fmt)
        back = read_feature_list(str(p))
        np.testing.assert_array_equal(back.val, fl.val)
        if fmt is None:
            np.testing.assert_array_equal(back.x, fl.x)

    fh = FeatureHistory.create(3)
    fh.x[:] = [1, 2, 3]
    fh.y[:] = [4, 5, 6]
    fh.val[:] = [0, 0, -1]
    p = tmp_path / "h.bin"
    write_feature_history(fh, str(p))
    back = read_feature_history(str(p))
    np.testing.assert_array_equal(back.x, fh.x)
    np.testing.assert_array_equal(back.val, fh.val)


def test_store_extract():
    ft = FeatureTable.create(3, 4)
    fl = FeatureList.create(4)
    fl.x[:] = [1, 2, 3, 4]
    fl.y[:] = [5, 6, 7, 8]
    fl.val[:] = [0, 0, -2, 9]
    ft.store_list(fl, 1)
    back = ft.extract_list(1)
    np.testing.assert_array_equal(back.x, fl.x)
    fh = ft.extract_history(2)
    assert fh.x[1] == 3 and fh.val[1] == -2


def test_pgm_roundtrip(tmp_path):
    img = (np.arange(200 * 100) % 251).astype(np.uint8).reshape(100, 200)
    p = tmp_path / "x.pgm"
    write_pgm(str(p), img)
    np.testing.assert_array_equal(read_pgm(str(p)), img)


def test_pgm_reads_reference_frame():
    path = "/root/reference/data/images_provided/img0.pgm"
    if not os.path.exists(path):
        pytest.skip("dataset unavailable")
    img = read_pgm(path)
    assert img.shape == (240, 320)
    assert img.dtype == np.uint8


def test_ppm_roundtrip_and_overlay(tmp_path):
    img = np.zeros((50, 60), np.uint8)
    fl = FeatureList.create(2)
    fl.x[:] = [10.2, 58.9]
    fl.y[:] = [10.6, 0.1]
    fl.val[:] = [0, 0]
    rgb = klt.feature_overlay(fl, img)
    assert tuple(rgb[11, 10]) == (255, 0, 0)  # rounded center
    p = tmp_path / "o.ppm"
    write_ppm(str(p), rgb)
    np.testing.assert_array_equal(read_ppm(str(p)), rgb)


def test_checkpoint_resume_via_feature_table(tmp_path):
    """The feature-table files are the checkpoint format (reference:
    KLTFT1 binary + KLTExtractFeatureList resume,
    src/V1/writeFeatures.c:294-301, src/V1/storeFeatures.c:42-66):
    tracking resumed from a stored frame must match uninterrupted
    tracking bit-for-bit (positions are stored as raw f32)."""
    import klt
    from klt.config import TrackingConfig
    from conftest import REF_DATA
    d = os.path.join(REF_DATA, "images_provided")
    if not os.path.isdir(d):
        pytest.skip("dataset unavailable")
    frames = [np.asarray(klt.read_pgm(os.path.join(d, f"img{i}.pgm")))
              for i in range(8)]

    cfg = TrackingConfig(sequential_mode=True)
    tr = klt.KLTracker(cfg)
    fl = klt.FeatureList.create(64)
    ft = klt.FeatureTable.create(8, 64)
    tr.select_good_features(frames[0], fl)
    ft.store_list(fl, 0)
    for i in range(1, 8):
        tr.track_features(frames[i - 1], frames[i], fl)
        ft.store_list(fl, i)
    full = (fl.x.copy(), fl.y.copy(), fl.val.copy())

    # checkpoint at frame 4, restart cold, resume
    path = str(tmp_path / "ckpt.ft")
    klt.write_feature_table(ft, path)
    ft2 = klt.read_feature_table(path)
    fl2 = ft2.extract_list(4)
    tr2 = klt.KLTracker(cfg)
    for i in range(5, 8):
        tr2.track_features(frames[i - 1], frames[i], fl2)

    np.testing.assert_array_equal(fl2.val, full[2])
    alive = full[2] >= 0
    np.testing.assert_array_equal(fl2.x[alive], full[0][alive])
    np.testing.assert_array_equal(fl2.y[alive], full[1][alive])


def test_detection_epochs_and_same_detection_parity():
    """utils.parity: epoch assignment tracks replacement events, and
    the same-detection drift metric excludes slots whose runs picked
    different replacement features."""
    import numpy as np
    from klt.utils.parity import detection_epochs, table_parity_stats

    # slot 0: tracked throughout; slot 1: replaced at t=2 (same pick);
    # slot 2: replaced at t=2 with DIFFERENT picks in the two runs
    v = np.array([[10, 0, 0, 0],
                  [11, -1, 12, 0],
                  [13, -1, 14, 0]], np.int32)
    ep = detection_epochs(v)
    np.testing.assert_array_equal(ep[0], [0, 0, 0, 0])
    np.testing.assert_array_equal(ep[1], [0, 0, 2, 2])

    x_r = np.array([[5., 5.1, 5.2, 5.3],
                    [9., -1., 20., 20.1],
                    [7., -1., 30., 30.1]], np.float32)
    y_r = np.zeros_like(x_r)
    x_o = x_r.copy()
    x_o[2, 2:] = [40., 40.6]   # different replacement pick, far away
    st = table_parity_stats(x_r, y_r, v, x_o, y_r, v)
    assert st["status_agreement"] == 1.0
    # co-live entries: slot2's post-replacement positions differ by 10px
    assert st["within_half_px"] < 1.0
    # but the divergent slot's entries are NOT same-detection
    assert st["within_half_px_same_detection"] == 1.0
    assert st["same_detection_frac"] < 1.0


def test_pad_features_for_mesh_dead_lanes():
    import numpy as np
    from klt.parallel.batch import pad_features_for_mesh
    x = np.ones((2, 5), np.float32)
    y = np.ones((2, 5), np.float32)
    v = np.zeros((2, 5), np.int32)
    xp, yp, vp, n = pad_features_for_mesh(x, y, v, 4)
    assert xp.shape == (2, 8) and n == 5
    assert (vp[:, 5:] == -1).all() and (vp[:, :5] == 0).all()
    x2, y2, v2, n2 = pad_features_for_mesh(x, y, v, 5)
    assert x2.shape == (2, 5) and n2 == 5
