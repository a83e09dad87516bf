"""tpuslam_torch's in-memory renderer against tpuslam's synthetic
sequence.

Tolerance: the hash lattice is integer-exact, but exp, sqrt and the
ray-direction matmul round differently in XLA and in PyTorch, so a pixel
near a .5 boundary can land one grey level apart: at most 1 level, on at
most 0.1 % of the pixels.  Timestamps and ground truth equal what
tpuslam's files give back through its dataset reader.
"""

import os

import numpy as np
import torch
import jax.numpy as jnp

from tpuslam.io import synthetic as J
from tpuslam_torch.io import synthetic as T


def test_hash_exact(rng):
    ix = rng.integers(-2 ** 31, 2 ** 31, 5000).astype(np.int32)
    iy = rng.integers(-2 ** 31, 2 ** 31, 5000).astype(np.int32)
    for salt in (0, 977, 11 * 4241 + 5):
        ref = np.asarray(J._hash01(jnp.asarray(ix), jnp.asarray(iy), salt))
        got = T._hash01(torch.as_tensor(ix), torch.as_tensor(iy), salt)
        np.testing.assert_array_equal(got.numpy(), ref)


def _grey_levels_close(got, ref):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3


def test_render_matches(rng):
    poses = T.forward_trajectory(30, 1.4, 0.003)
    jw = J.BoxWorld(poses, seed=11)
    tw = T.BoxWorld(poses, seed=11)
    np.testing.assert_array_equal(tw.box, jw.box)
    for p in (poses[0], poses[17]):
        ref = jw.render(p, 180.0, 79.5, 59.5, 120, 160)
        got = tw.render(p, 180.0, 79.5, 59.5, 120, 160,
                        device="cpu").numpy()
        _grey_levels_close(got, ref)


def test_sequence_matches_written_files(tmp_path):
    from tpuslam.io.dataset import StereoImageDataset
    from tpuslam.geometry.camera import StereoCameraModel
    kw = dict(n_frames=3, width=96, height=64, f=80.0, baseline=0.54,
              speed=0.4, yaw_rate=0.002, seed=3)
    out = str(tmp_path)
    J.make_sequence(out, **kw)
    ds = StereoImageDataset(os.path.join(out, "image_0"),
                            os.path.join(out, "image_1"),
                            os.path.join(out, "times.txt"),
                            os.path.join(out, "poses.txt"))
    left, right, stamps, gt = T.make_sequence(**kw, device="cpu")
    assert left.shape == right.shape == (3, 64, 96)
    assert left.dtype == torch.uint8
    for i in range(3):
        it = ds[i]
        _grey_levels_close(left[i].numpy(), it["left"])
        _grey_levels_close(right[i].numpy(), it["right"])
        assert stamps[i] == it["stamp"]
        np.testing.assert_array_equal(gt[i], it["ground_truth"])
    cam = StereoCameraModel.load_kitti(os.path.join(out, "calib.txt"),
                                       image_size=(96, 64))
    tc = T.sequence_camera(96, 64, 80.0, 0.54)
    np.testing.assert_array_equal(tc.P_l, cam.P_l)
    np.testing.assert_array_equal(tc.P_r, cam.P_r)
    assert (tc.width, tc.height) == (96, 64)
