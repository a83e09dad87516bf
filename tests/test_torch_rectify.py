"""tpuslam_torch's rectification (kernels/rectify.py) against tpuslam's.

The maps are numpy copies (held equal in test_torch_config.py and here by
value); the integer warp, bit-exact with rect_intp.v, equals tpuslam's bit
for bit; the float warp agrees within 1e-4 (XLA's CPU backend contracts
its multiply-adds); StereoRectifier end to end on the raw fixture pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.kernels import rectify as J
from tpuslam_torch.kernels import rectify as T


@pytest.fixture(scope="module")
def raw_pair():
    import os
    fx = os.path.join(os.path.dirname(__file__), "fixtures")
    return (np.load(os.path.join(fx, "raw_left.npy")),
            np.load(os.path.join(fx, "raw_right.npy")))


def _rot(rng):
    a = rng.normal(size=3) * 0.03
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + K + K @ K / 2


def test_reference_calib_equal():
    for a, b in zip(T.REFERENCE_CALIB, J.REFERENCE_CALIB):
        assert (a.f, a.c, a.f2inv, a.c2_f2) == (b.f, b.c, b.f2inv, b.c2_f2)
        np.testing.assert_array_equal(a.rot, b.rot)
    q = T.RectCamera.from_float((500.0, 501.0), (320.2, 239.7),
                                (505.0, 506.0), (318.0, 242.0), np.eye(3))
    r = J.RectCamera.from_float((500.0, 501.0), (320.2, 239.7),
                                (505.0, 506.0), (318.0, 242.0), np.eye(3))
    assert (q.f, q.c, q.f2inv, q.c2_f2) == (r.f, r.c, r.f2inv, r.c2_f2)


@pytest.mark.parametrize("cam", [0, 1])
def test_maps_equal(cam):
    mj = J.rect_map_fixed(J.REFERENCE_CALIB[cam], 480, 640)
    mt = T.rect_map_fixed(T.REFERENCE_CALIB[cam], 480, 640)
    for a, b in zip(mt, mj):
        assert a.dtype == np.int16
        np.testing.assert_array_equal(a, b)
    R = _rot(np.random.default_rng(cam))
    args = ((500.0, 501.0), (320.0, 240.0), (505.0, 505.0), (318.0, 242.0),
            R, 120, 160)
    for a, b in zip(T.rect_map_float(*args), J.rect_map_float(*args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cam", [0, 1])
def test_hw_warp_bit_equal(raw_pair, cam):
    """The fixed-point warp of the raw fixture image by the reference
    calibration's maps; some output pixels fall outside (0)."""
    img = raw_pair[cam]
    maps = T.rect_map_fixed(T.REFERENCE_CALIB[cam], 480, 640)
    want = np.asarray(J.remap_bilinear_hw(jnp.asarray(img),
                                          *map(jnp.asarray, maps)))
    got = T.remap_bilinear_hw(torch.from_numpy(img),
                              *map(torch.from_numpy, maps))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_hw_warp_edges():
    """Maps that leave the image on every side, with every fraction, and
    a saturating 255 neighbourhood."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (9, 11)).astype(np.uint8)
    img[:3, :3] = 255
    mx = rng.integers(-64, 12 * 32, (15, 17)).astype(np.int16)
    my = rng.integers(-64, 10 * 32, (15, 17)).astype(np.int16)
    want = np.asarray(J.remap_bilinear_hw(jnp.asarray(img), jnp.asarray(mx),
                                          jnp.asarray(my)))
    got = T.remap_bilinear_hw(torch.from_numpy(img), torch.from_numpy(mx),
                              torch.from_numpy(my)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 0).any() and (want > 0).any()


def test_float_warp_close(raw_pair):
    R = _rot(np.random.default_rng(5))
    maps = T.rect_map_float((500.0, 500.0), (320.0, 240.0), (505.0, 505.0),
                            (318.0, 242.0), R, 480, 640)
    want = np.asarray(J.remap_bilinear(jnp.asarray(raw_pair[0]),
                                       *map(jnp.asarray, maps)))
    got = T.remap_bilinear(torch.from_numpy(raw_pair[0]),
                           *map(torch.from_numpy, maps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (want == 0).any()


def test_stereo_rectifier_end_to_end(raw_pair):
    """from_reference_calib on the CPU: both images bit-equal to
    tpuslam's; the maps live on the rectifier's device; a batch of frames
    warps as each frame alone."""
    left, right = raw_pair
    rj = J.StereoRectifier.from_reference_calib()
    rt = T.StereoRectifier.from_reference_calib(device="cpu")
    assert rt._mx_l.device.type == "cpu" and rt._fixed
    (jl, jr), (tl, tr) = rj(left, right), rt(left, right)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    bl, br = rt(np.stack([left, right]), np.stack([right, left]))
    np.testing.assert_array_equal(bl[0].numpy(), tl.numpy())
    np.testing.assert_array_equal(br[0].numpy(), tr.numpy())
