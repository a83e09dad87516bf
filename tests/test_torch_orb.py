"""tpuslam_torch ORB descriptors and matching helpers against tpuslam's.

Blur tolerance: XLA's CPU backend contracts orb_blur's multiply-adds into
FMAs (emulating the FMA in float64 reproduces tpuslam's CPU blur exactly),
while the port keeps the Pallas kernel's uncontracted f32 order, as
kernel K3 does on the card.  A result that lands on .5 can then round the
other way, so the blur may differ by one grey level at a few pixels:
at most 1 level on at most 1e-4 of the pixels.  Given the same blurred
image, the 256 tests and their packing are bit-equal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuslam.kernels import orb as J
from tpuslam.kernels import matching as JM
from tpuslam.kernels import gftt as JG
from tpuslam_torch.kernels import orb as T
from tpuslam_torch.kernels import matching as TM


def test_pattern_and_offsets_equal():
    np.testing.assert_array_equal(T.orb_pattern(), J.orb_pattern())
    np.testing.assert_array_equal(T.gaussian_kernel_7_sigma2(),
                                  J.gaussian_kernel_7_sigma2())
    for a, b in zip(T._const_angle_offsets(-1.0),
                    J._const_angle_offsets(-1.0)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rows", [None, 376])
def test_blur_within_one_level(stereo_pair, rows):
    left = np.ascontiguousarray(stereo_pair[0][:rows])
    ref = np.asarray(J.orb_blur(left)).astype(np.int32)
    got = T.orb_blur(torch.as_tensor(left)[None])[0].numpy().astype(np.int32)
    diff = np.abs(got - ref)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4


def _keypoints(img, C=768):
    """tpuslam's own fused-path keypoints, border-filtered."""
    h, w = img.shape
    v, i, _, _ = JG.gftt_candidates(jnp.asarray(img), jnp.float32(0.01), 3,
                                    max_candidates=4096)
    k, valid, _ = JG.select_from_candidates_device(
        v, i, w, jnp.float32(7.0), max_features=1500, capacity=C)
    k, valid = np.asarray(k), np.asarray(valid)
    keep = valid & (k[:, 0] >= 19) & (k[:, 0] < w - 19) & \
        (k[:, 1] >= 19) & (k[:, 1] < h - 19)
    xy = np.zeros((C, 2), np.float32)
    xy[:keep.sum()] = k[keep, :2]
    return xy, np.arange(C) < keep.sum()


@pytest.mark.parametrize("rows", [None, 376])
def test_descriptors_bit_equal(stereo_pair, rows):
    left = np.ascontiguousarray(stereo_pair[0][:rows])
    xy, valid = _keypoints(left)
    assert valid.sum() > 100
    blurred = np.array(J.orb_blur(left))
    ref = np.asarray(J._orb_descriptors_const_angle_device(
        jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(valid),
        jnp.asarray(J.orb_pattern()), len(xy), angle_deg=-1.0))
    got = T.descriptors_from_blurred(torch.as_tensor(blurred)[None],
                                     torch.as_tensor(xy)[None],
                                     torch.as_tensor(valid)[None])[0]
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_descriptors_batched(stereo_pair):
    """The dispatcher's plain path over a 2-frame batch equals the
    per-frame blur + tests."""
    left, right = stereo_pair
    imgs = np.stack([left[:376], right[:376]])
    xy = np.stack([_keypoints(np.ascontiguousarray(im))[0] for im in imgs])
    valid = np.stack([_keypoints(np.ascontiguousarray(im))[1]
                      for im in imgs])
    got = T.orb_descriptors_const_angle(torch.as_tensor(imgs),
                                        torch.as_tensor(xy),
                                        torch.as_tensor(valid))
    for b in range(2):
        blurred = T.orb_blur(torch.as_tensor(imgs[b])[None])
        one = T.descriptors_from_blurred(blurred, torch.as_tensor(xy[b])[None],
                                         torch.as_tensor(valid[b])[None])
        assert torch.equal(got[b], one[0])
        assert not got[b][~torch.as_tensor(valid[b])].any()


def test_unpack_bits_and_hamming(rng):
    a = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (48, 32), dtype=np.uint8)
    ta, tb = TM.unpack_bits(torch.as_tensor(a)), TM.unpack_bits(
        torch.as_tensor(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(JM.unpack_bits(a)))
    dist = (ta.sum(1)[:, None] + tb.sum(1)[None, :] - 2.0 * (ta @ tb.T))
    np.testing.assert_array_equal(dist.numpy(),
                                  np.asarray(JM.hamming_matrix(a, b)))


def test_top2_min_ties_go_low(rng):
    d = rng.integers(0, 6, (40, 70)).astype(np.float32)   # many ties
    d[3] = 1e9
    for got, ref in zip(TM._top2_min(torch.as_tensor(d)),
                        JM._top2_min(jnp.asarray(d))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

