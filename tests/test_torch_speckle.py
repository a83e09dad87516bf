"""tpuslam_torch's speckle filter against tpuslam's and cv2.filterSpeckles.

tpuslam runs a fixed 16 rounds of min-label hooking with pointer jumping
(its `converged` flag says whether one more hook would change a label);
the port hooks labels until nothing changes (so it has no such flag) and
is cv::filterSpeckles exactly on every input, and equals tpuslam bit for bit wherever tpuslam's
flag is True.  Where tpuslam's flag is False a component still carries
several labels, each counted as a component of its own, so tpuslam can
only filter more: every pixel where the two differ is `filtered` in
tpuslam's map and unfiltered in the port's.  The fixture pair's own
disparity is such an input (tpuslam filters 91 pixels that OpenCV keeps).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.config import StereoBMConfig as JCfg
from tpuslam.kernels import stereo_bm as J
from tpuslam_torch.config import StereoBMConfig
from tpuslam_torch.kernels import stereo_bm as T


MAX_SIZE, MAX_DIFF, FILTERED = 50, 32, -16     # SlamConfig().bm's
_jax_speckle = jax.jit(J.speckle_filter_with_flag, static_argnums=(1, 2, 3))


def _cv2(d, max_size=MAX_SIZE, max_diff=MAX_DIFF, filtered=FILTERED):
    out = np.asarray(d, np.int16).copy()
    cv2.filterSpeckles(out, filtered, max_size, max_diff)
    return out


def _port(d, max_size=MAX_SIZE, max_diff=MAX_DIFF):
    return T.speckle_filter(torch.as_tensor(d), max_size, max_diff,
                            FILTERED).numpy()


def _assert_only_more_filtered(ref, got):
    """Where tpuslam (ref) and the port (got) differ, tpuslam filtered a
    pixel that the port kept."""
    diff = ref != got
    assert (ref[diff] == FILTERED).all() and (got[diff] != FILTERED).all()


def _blobs(seed, h, w, cell):
    """Blocks of disparity (steps of 16) with +-20 noise and 15 % filtered
    pixels: small and large components, some joined across blocks."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 64, (-(-h // cell), -(-w // cell))) * 16
    d = np.kron(base, np.ones((cell, cell), np.int64))[:h, :w]
    d = d + rng.integers(-20, 21, (h, w))
    d[rng.uniform(size=(h, w)) < 0.15] = FILTERED
    return d.astype(np.int32)


def _serpentine(h, w):
    """One 1-pixel-wide boustrophedon path through an (h, w) map."""
    d = np.full((h, w), FILTERED, np.int32)
    d[0::2, :] = 100
    for k, y in enumerate(range(1, h, 2)):
        d[y, w - 1 if k % 2 == 0 else 0] = 100
    return d


@pytest.fixture(scope="module")
def fixture_disp(stereo_pair):
    """tpuslam's StereoBM of the fixture pair in SlamConfig()'s settings,
    without and with speckle."""
    left, right = stereo_pair
    return (np.asarray(J.stereo_bm(left, right, JCfg(), with_speckle=False)),
            np.asarray(J.stereo_bm(left, right, JCfg(), with_speckle=True)))


def test_fixture_pair(fixture_disp):
    """On the fixture pair's disparity (computed without speckle) the port
    is cv2.filterSpeckles; tpuslam's 16 rounds do not converge there, and
    where it differs it filtered more."""
    raw, _ = fixture_disp
    got = _port(raw.astype(np.int32))
    ref, ref_conv = _jax_speckle(jnp.asarray(raw, jnp.int32), MAX_SIZE,
                                 MAX_DIFF, FILTERED)
    ref = np.asarray(ref)
    assert not bool(ref_conv)
    np.testing.assert_array_equal(got, _cv2(raw))
    _assert_only_more_filtered(ref, got)
    assert 0 < (ref != got).sum() < 200
    assert T.SPECKLE_ROUNDS[-1] % T.SPECKLE_CHECK_EVERY == 0


@pytest.mark.parametrize("shape, cell", [((48, 64), 6), ((120, 200), 10)])
@pytest.mark.parametrize("seed", range(4))
def test_random_blob_maps(shape, cell, seed):
    """Bit-equal to tpuslam wherever tpuslam's flag is True (both kinds
    occur among these maps), to cv2.filterSpeckles always."""
    d = _blobs(seed, *shape, cell)
    got = _port(d)
    ref, ref_conv = _jax_speckle(jnp.asarray(d), MAX_SIZE, MAX_DIFF,
                                 FILTERED)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got, _cv2(d))
    if bool(ref_conv):
        np.testing.assert_array_equal(got, ref)
    else:
        _assert_only_more_filtered(ref, got)


@pytest.mark.parametrize("vertical", [False, True])
def test_serpentine_component(vertical):
    """One winding component of 8,256 pixels: tpuslam's 16 rounds do not
    label it whole (flag False), the port does (its labels ran to their
    fixpoint, a whole number of checks) and equals cv2.filterSpeckles, keeping it under a window below its size
    and removing it under one above."""
    d = _serpentine(128, 128)
    if vertical:
        d = np.ascontiguousarray(d.T)
    n = int((d != FILTERED).sum())
    _, ref_conv = _jax_speckle(jnp.asarray(d), n - 1, 0, FILTERED)
    assert not bool(ref_conv)
    for max_size in (n - 1, n):
        got = _port(d, max_size, 0)
        assert T.SPECKLE_ROUNDS[-1] % T.SPECKLE_CHECK_EVERY == 0
        np.testing.assert_array_equal(got, _cv2(d, max_size, 0))
        assert (got == FILTERED).all() == (max_size == n)


def test_batch_version():
    """The batch version over (3, H, W) equals the per-frame version on
    each frame (labels never cross frames), and tpuslam's
    speckle_filter_batch where that converged."""
    batch = np.stack([_blobs(s, 48, 64, 6) for s in range(3)])
    got = T.speckle_filter_batch(torch.as_tensor(batch), MAX_SIZE,
                                 MAX_DIFF, FILTERED).numpy()
    for f in range(3):
        np.testing.assert_array_equal(got[f], _port(batch[f]))
    ref, ref_conv = jax.jit(J.speckle_filter_batch,
                            static_argnums=(1, 2, 3))(
        jnp.asarray(batch), MAX_SIZE, MAX_DIFF, FILTERED)
    assert bool(ref_conv)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_stereo_bm_with_speckle(stereo_pair, fixture_disp):
    """The port's stereo_bm(with_speckle=True) on the fixture pair is
    cv2.filterSpeckles of tpuslam's disparity without speckle, and
    differs from tpuslam's stereo_bm(with_speckle=True) only where
    tpuslam's unconverged labels filtered more."""
    raw, ref = fixture_disp
    left, right = (torch.as_tensor(a)[None] for a in stereo_pair)
    got = T.stereo_bm(left, right, StereoBMConfig())[0].numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, _cv2(raw))
    _assert_only_more_filtered(ref, got)
    no_speckle = T.stereo_bm(left, right, StereoBMConfig(),
                             with_speckle=False)[0].numpy()
    np.testing.assert_array_equal(no_speckle, raw)
    # the speckle pass is off where its window or range says so
    for cfg in (StereoBMConfig(speckle_window_size=0),
                StereoBMConfig(speckle_range=-1)):
        np.testing.assert_array_equal(
            T.speckle_bm(torch.tensor(raw)[None], cfg)[0].numpy(), raw)


def test_fused_front_end_with_speckle(stereo_pair):
    """With fused_speckle the fused front end's disparity is the
    per-frame speckled one (port-internal), and without it the
    unspeckled one."""
    from tpuslam_torch.config import SlamConfig
    from tpuslam_torch.io.synthetic import sequence_camera
    from tpuslam_torch.vo.fused import FusedShapes, make_frontend_fn
    rows = 96
    left = torch.as_tensor(np.stack([stereo_pair[0][:rows],
                                     stereo_pair[0][rows:2 * rows]]))
    right = torch.as_tensor(np.stack([stereo_pair[1][:rows],
                                      stereo_pair[1][rows:2 * rows]]))
    cam = sequence_camera(640, rows, 500.0, 0.06)
    shapes = FusedShapes(chunk=2, capacity=384, n_cand=512)
    for fused in (True, False):
        cfg = SlamConfig().replace(fused_speckle=fused)
        feats = make_frontend_fn(cam, cfg, shapes, device="cpu")(left,
                                                                  right)
        want = T.stereo_bm(left, right, cfg.bm, with_speckle=fused)
        np.testing.assert_array_equal(feats["disp_dec"].numpy(),
                                      want[:, ::4, ::4].numpy())
    assert not np.array_equal(
        T.stereo_bm(left, right, cfg.bm, with_speckle=True).numpy(),
        want.numpy())
