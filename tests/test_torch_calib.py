"""tpuslam_torch's calibration against tpuslam's, on the CPU.

The chessboard views are tests/test_calib.py's rig (K1, K2, D1, D2,
R_LR, T_LR and its view distribution), six of them, rendered with the
numpy renderer both packages share (supersampled 2x here, for time).
Tolerances:
- the saddle response to atol 1e-3 (peaks ~1e3): tpuslam's sums are
  contracted into FMAs by XLA's CPU backend, the port's are not;
- the detected corners to 1e-6 px, with the same ok flags and order;
- the LM refinements run in float32 on both sides (JAX's x64 is off in
  tpuslam) and their accept test lies below one float32 ulp, so they are
  held on the same corners to K 1e-4 relative, D 1e-4, rotations 1e-5
  rad, T 1e-5 m and rms 1e-4 relative: each an order or more inside the
  JAX suite's gates (f within 2 %, |T| within 1 mm;
  tests/test_calib.py:71-86).
"""

import os

import numpy as np
import pytest
import torch

from tpuslam.calib import find_chessboard as j_find
from tpuslam.calib import render_chessboard
from tpuslam.calib.calibrate import _rvec
from tpuslam.calib.chessboard import _rodrigues, saddle_response as j_saddle


# tests/test_calib.py:19-24's rig
K1 = np.array([[520.0, 0, 321.0], [0, 518.0, 242.0], [0, 0, 1]])
K2 = np.array([[515.0, 0, 318.0], [0, 516.0, 239.0], [0, 0, 1]])
R_LR = _rodrigues(np.array([0.004, -0.02, 0.006]))
T_LR = np.array([-0.061, 0.001, 0.002])
D1 = [0.06, -0.04, 0, 0]
D2 = [0.05, -0.03, 0, 0]
N_VIEWS, SUPERSAMPLE, SIZE = 6, 2, (640, 480)
K_REL, D_ABS, ROT, T_M, RMS_REL = 1e-4, 1e-4, 1e-5, 1e-5, 1e-4


@pytest.fixture(scope="module")
def views():
    """(left images, right images, tpuslam's left and right corners) of
    the views tpuslam detects in both cameras (tests/test_calib.py:27-47's
    draws)."""
    rng = np.random.default_rng(1)
    il, ir, cl, cr = [], [], [], []
    for _ in range(N_VIEWS):
        rvec = rng.uniform(-0.35, 0.35, 3)
        rvec[2] = rng.uniform(-0.25, 0.25)
        tvec = np.array([rng.uniform(-0.08, -0.02),
                         rng.uniform(-0.07, -0.02),
                         rng.uniform(0.35, 0.6)])
        img_l, _ = render_chessboard(K1, rvec, tvec, dist=D1,
                                     supersample=SUPERSAMPLE)
        img_r, _ = render_chessboard(
            K2, _rvec(R_LR @ _rodrigues(rvec)), R_LR @ tvec + T_LR,
            dist=D2, supersample=SUPERSAMPLE)
        a, oka = j_find(img_l)
        b, okb = j_find(img_r)
        il.append(img_l)
        ir.append(img_r)
        if oka and okb:
            cl.append(a)
            cr.append(b)
    assert len(cl) >= 5
    return il, ir, cl, cr


def test_saddle_response(views):
    from tpuslam_torch.calib.chessboard import saddle_response
    il, ir, _, _ = views
    for img in (il[0], ir[1]):
        ref = np.asarray(j_saddle(img))
        got = saddle_response(torch.as_tensor(img)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_find_chessboard(views):
    """The same ok flag and corner order, corners within 1e-6 px, in
    every view of both cameras and on an image with no board."""
    from tpuslam_torch.calib import find_chessboard
    il, ir, _, _ = views
    for img in il + ir + [np.full((480, 640), 128, np.uint8)]:
        ref, ok_ref = j_find(img)
        got, ok = find_chessboard(img, device="cpu")
        assert ok == ok_ref
        if ok:
            assert got.shape == ref.shape == (54, 2)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        else:
            assert got is None


def _hold_k(got, ref):
    np.testing.assert_allclose(got, ref, rtol=K_REL, atol=0)


def test_calibrate_camera(views):
    """Mono calibration of each camera on tpuslam's corners."""
    from tpuslam.calib import calibrate_camera as J
    from tpuslam_torch.calib import calibrate_camera as T
    _, _, cl, cr = views
    for corners in (cl, cr):
        ref = J(corners, 9, 6, 0.025, SIZE)
        got = T(corners, 9, 6, 0.025, SIZE, device="cpu")
        _hold_k(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=D_ABS)
        np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=ROT)
        np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=T_M)
        assert got[4] == pytest.approx(ref[4], rel=RMS_REL)


def _hold_stereo(got, ref):
    for k in ("K1", "K2"):
        _hold_k(got[k], ref[k])
    for k in ("D1", "D2"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=D_ABS)
    np.testing.assert_allclose(got["R"], ref["R"], rtol=0, atol=ROT)
    np.testing.assert_allclose(got["T"], ref["T"], rtol=0, atol=T_M)
    assert got["rms"] == pytest.approx(ref["rms"], rel=RMS_REL)


def test_stereo_calibrate(views):
    """Stereo calibration on tpuslam's corners, and the JAX suite's own
    gates on the port's result."""
    from tpuslam.calib import stereo_calibrate as J
    from tpuslam_torch.calib import stereo_calibrate as T
    _, _, cl, cr = views
    ref = J(cl, cr, 9, 6, 0.025, SIZE)
    got = T(cl, cr, 9, 6, 0.025, SIZE, device="cpu")
    _hold_stereo(got, ref)
    assert got["rms"] < 0.5
    assert abs(got["K1"][0, 0] - K1[0, 0]) / K1[0, 0] < 0.02
    assert abs(np.linalg.norm(got["T"]) - np.linalg.norm(T_LR)) < 0.001
    assert got["T"][0] < 0


def _camera_yaml(path):
    """The numbers of a camera_info YAML file, by key."""
    out, key = {}, None
    for line in open(path):
        name, _, val = line.strip().partition(":")
        if name in ("image_width", "image_height", "camera_name"):
            out[name] = val.strip()
        elif name == "data":
            out[key] = np.array([float(v) for v in
                                 val.strip(" []").split(",")])
        elif not line.startswith(" "):
            key = name
    return out


def test_stereo_calib_cli(views, tmp_path):
    """stereo_calib.run over the views written as PNGs (image_0/,
    image_1/): the returned calibration and the four YAML files' matrices
    within the tolerances above (rectification and Q to 1e-4 relative)."""
    from tpuslam.calib import read_opencv_yaml
    from tpuslam.cli.stereo_calib import run as J
    from tpuslam_torch.cli.stereo_calib import run as T
    from tpuslam_torch.io.png import write_png
    il, ir, _, _ = views
    for sub, imgs in (("image_0", il), ("image_1", ir)):
        os.makedirs(tmp_path / "views" / sub)
        for i, img in enumerate(imgs):
            write_png(str(tmp_path / "views" / sub / f"{i:03d}.png"), img)
    for side in ("ref", "got"):
        os.makedirs(tmp_path / side)
    ref = J(str(tmp_path / "views"), out_dir=str(tmp_path / "ref"),
            quiet=True)
    got = T(str(tmp_path / "views"), out_dir=str(tmp_path / "got"),
            quiet=True, device="cpu")
    assert got["n_views"] == ref["n_views"] >= 5
    _hold_stereo(got, ref)
    for k in ("R1", "R2", "P1", "P2", "Q"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6)
    for name in ("intrinsics.yml", "extrinsics.yml"):
        a = read_opencv_yaml(str(tmp_path / "got" / name))
        b = read_opencv_yaml(str(tmp_path / "ref" / name))
        assert list(a) == list(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6)
    for name in ("left_camera.yml", "right_camera.yml"):
        a = _camera_yaml(tmp_path / "got" / name)
        b = _camera_yaml(tmp_path / "ref" / name)
        assert list(a) == list(b) and len(b) == 7
        for k in b:
            if isinstance(b[k], str):
                assert a[k] == b[k]
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4,
                                           atol=1e-6)
