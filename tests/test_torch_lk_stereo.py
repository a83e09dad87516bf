"""tpuslam_torch's LK stereo (kernels/lk_stereo.py) against tpuslam's.

On the real 640x480 fixture pair: the Scharr derivative bit for bit, the
pyramid within one level and equal on at least 99.9 % of the pixels (its
sums are exact in f32, so in fact everywhere), and the tracker over 256
points (capacity 256 keeps JAX's compile short), some of them at the
image's borders and beyond: status equal and x within 1e-4 px.  XLA's CPU
backend contracts the 2x2 system's multiply-adds into FMAs and divides by
a constant as a multiply; the port takes those steps with one rounding
(kernels/lk_stereo.py), which is what makes a pixel-level agreement
possible on these ill-conditioned points.  Then the disparity gate of
compute_correspondences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.kernels import lk_stereo as J
from tpuslam_torch.kernels import lk_stereo as T


N_POINTS = 256


def _points(left):
    """GFTT-like corners (the strongest gradients' pixels) and random
    points, a few of them outside the image; the last 16 invalid."""
    rng = np.random.default_rng(0)
    h, w = left.shape
    gy, gx = np.gradient(left.astype(np.float32))
    score = (gx * gx + gy * gy)[8:-8, 8:-8]
    flat = np.argsort(score.ravel())[::-1][:4000:20][:150]
    corners = np.stack([flat % (w - 16) + 8, flat // (w - 16) + 8], 1)
    rand = np.stack([rng.uniform(-30, w + 30, N_POINTS - len(corners)),
                     rng.uniform(-10, h + 10, N_POINTS - len(corners))], 1)
    pts = np.concatenate([corners, rand]).astype(np.float32)
    valid = np.ones(N_POINTS, bool)
    valid[-16:] = False
    return pts, valid


def test_scharr_bit_equal(stereo_pair):
    for img in stereo_pair:
        want = np.asarray(J.scharr_deriv(jnp.asarray(img)))
        got = T.scharr_deriv(torch.from_numpy(img)).numpy()
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, want)


def test_pyramid_matches_reference(stereo_pair):
    """Every level of the 6-level pyramid within one level of tpuslam's and
    equal on at least 99.9 % of its pixels; derivatives equal where the
    levels are."""
    left, _ = stereo_pair
    ref = J.build_lk_pyramid(jnp.asarray(left), 5)
    got = T.build_lk_pyramid(torch.from_numpy(left), 5)
    assert len(got) == len(ref) == 6
    for (ri, rd), (gi, gd) in zip(ref, got):
        ri, gi = np.asarray(ri).astype(int), gi.numpy().astype(int)
        assert gi.shape == ri.shape
        assert np.abs(gi - ri).max() <= 1
        assert (gi == ri).mean() >= 0.999
        if (gi == ri).all():
            np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))


@pytest.fixture(scope="module")
def tracked(stereo_pair):
    left, right = stereo_pair
    pts, valid = _points(left)
    ref = [np.asarray(x) for x in J.lk_stereo(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(pts),
        jnp.asarray(valid))]
    got = [x.numpy() for x in T.lk_stereo(left, right, pts, valid,
                                          device="cpu")]
    return ref, got, pts, valid


def test_tracker_matches_reference(tracked):
    """Status equal, x within 1e-4 px, y carried through, err (the
    minimum eigenvalue) within f32 rounding."""
    (rn, rs, re), (gn, gs, ge), pts, valid = tracked
    np.testing.assert_array_equal(gs, rs)
    assert 50 < rs.sum() < valid.sum()       # tracked and lost points
    assert not rs[~valid].any()
    np.testing.assert_allclose(gn[:, 0], rn[:, 0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(gn[:, 1], pts[:, 1])
    np.testing.assert_allclose(ge, re, rtol=1e-6, atol=1e-12)


def test_tracker_other_window(stereo_pair):
    """Another window, depth and iteration count: status agreement of at
    least 99 % and x within 0.05 px where both tracked."""
    left, right = stereo_pair
    pts, valid = _points(left)
    kw = dict(win=(21, 5), max_level=3, max_iters=20, eps=0.02)
    rn, rs, _ = (np.asarray(x) for x in J.lk_stereo(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(pts),
        jnp.asarray(valid), **kw))
    gn, gs, _ = (x.numpy() for x in T.lk_stereo(left, right, pts, valid,
                                                device="cpu", **kw))
    assert (gs == rs).mean() >= 0.99
    both = gs & rs
    assert both.sum() > 50
    np.testing.assert_allclose(gn[both, 0], rn[both, 0], rtol=0, atol=0.05)


def test_disparity_gate(stereo_pair, tracked):
    """compute_correspondences: the LK track plus the gate (0.5, 128],
    equal to tpuslam's; the gate drops some tracked points."""
    left, right = stereo_pair
    _, (gn, gs, _), pts, valid = tracked
    want = J.compute_correspondences(left, right, pts, valid)
    got = T.compute_correspondences(left, right, pts, valid, device="cpu")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    assert got[1].sum() < gs.sum()
    d = pts[:, 0] - got[0][:, 0]
    assert ((d > 0.5) & (d <= 128.0))[got[1]].all()
