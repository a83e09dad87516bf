"""tpuslam_torch GFTT against tpuslam's.

Tolerances: XLA's CPU backend contracts multiply-adds into FMAs, which the
port's plain path and kernel K2 deliberately do not (the Pallas kernel's
order on the TPU has none), so the f32 response may differ from tpuslam's
CPU result in the last bits.  tpuslam's own suite holds its Pallas
interpret path to its XLA path at rtol 2e-6 / atol 1e-7 for the same
reason (test_kernels.py test_response_dil_pallas_equivalent), and so does
this file.  Everything downstream of the response is compared exactly:
the candidate mask, the top-k order including ties, and the NMS set.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuslam.kernels import gftt as J
from tpuslam_torch.kernels import gftt as T


def _eig_pair(img):
    eig_j, dil_j = J.gftt_response_dil_pallas(jnp.asarray(img),
                                              interpret=True)
    eig_t, dil_t = T.gftt_response_dil_plain(torch.as_tensor(img)[None])
    return (np.asarray(eig_j), np.asarray(dil_j), eig_t[0].numpy(),
            dil_t[0].numpy())


@pytest.mark.parametrize("rows", [None, 376])
def test_response_and_dilation(stereo_pair, rows):
    left = np.ascontiguousarray(stereo_pair[0][:rows])
    eig_j, dil_j, eig_t, dil_t = _eig_pair(left)
    np.testing.assert_allclose(eig_t, eig_j, rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(dil_t, dil_j, rtol=2e-6, atol=1e-7)
    # the plain dilation is exactly the 3x3 max of the plain response
    ref_dil = np.asarray(J.local_max_3x3(jnp.asarray(eig_t)))
    np.testing.assert_array_equal(dil_t, ref_dil)
    # and the candidate masks agree exactly
    thr_j = eig_j.max() * np.float32(0.01)
    thr_t = eig_t.max() * np.float32(0.01)
    np.testing.assert_array_equal((eig_t > thr_t) & (eig_t == dil_t),
                                  (eig_j > thr_j) & (eig_j == dil_j))


@pytest.mark.parametrize("shape", [(5, 7), (17, 130), (3, 9)])
def test_response_and_dilation_small_shapes(shape):
    """The plain version of K2 against the Pallas kernel (interpret mode)
    on random images whose sides are not whole tiles of either: 5x7, 17
    rows across two of the Pallas kernel's 16-row strips, and 3 rows,
    where reflect-101 reaches across the whole image."""
    img = np.random.default_rng(4).integers(0, 256, shape).astype(np.uint8)
    eig_j, dil_j, eig_t, dil_t = _eig_pair(img)
    np.testing.assert_allclose(eig_t, eig_j, rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(dil_t, dil_j, rtol=2e-6, atol=1e-7)
    assert (eig_t > 0).any()


def test_two_stage_top_k_bit_equal_with_ties():
    """Values everywhere, indices wherever the value is finite, including
    exact ties spanning segment boundaries (lax.top_k breaks ties toward
    the lower index; the port sorts stably)."""
    n = 376 * 1241
    rng = np.random.default_rng(7)
    cases = []
    for n_pts, reps in ((3000, 1), (9000, 6), (12000, 1)):
        a = np.full(n, -np.inf, np.float32)
        ii = rng.choice(n, n_pts, replace=False)
        a[ii] = np.repeat(rng.random(n_pts // reps).astype(np.float32),
                          reps)
        cases.append(a)
    got_v, got_i = T._two_stage_top_k(torch.as_tensor(np.stack(cases)),
                                      4096)
    for b, x in enumerate(cases):
        v, i = J._two_stage_top_k(jnp.asarray(x), 4096)
        v, i = np.asarray(v), np.asarray(i)
        np.testing.assert_array_equal(got_v[b].numpy(), v)
        fin = np.isfinite(v)
        np.testing.assert_array_equal(got_i[b].numpy()[fin], i[fin])


def test_candidates_bit_equal(stereo_pair):
    """gftt_candidates over a 2-frame batch: (vals, idx) and the
    candidate count equal tpuslam's on the fixture and on a crop."""
    left = stereo_pair[0]
    frames = [np.ascontiguousarray(left[:376]),
              np.ascontiguousarray(left[100:476])]
    vals, idx, maxv, ncand = T.gftt_candidates(
        torch.as_tensor(np.stack(frames)), 0.01, 3, max_candidates=4096)
    for b, img in enumerate(frames):
        v, i, _, nc = J.gftt_candidates(jnp.asarray(img), jnp.float32(0.01),
                                        3, max_candidates=4096)
        v, i = np.asarray(v), np.asarray(i)
        fin = np.isfinite(v)
        assert int(ncand[b]) == int(nc)
        np.testing.assert_array_equal(idx[b].numpy()[fin], i[fin])
        np.testing.assert_allclose(vals[b].numpy(), v, rtol=2e-6, atol=1e-7)


def test_nms_bit_equal(stereo_pair):
    """The greedy min-distance NMS, fed tpuslam's candidates, accepts
    exactly tpuslam's keypoints in the same order."""
    left = stereo_pair[0]
    w = left.shape[1]
    v, i, _, _ = J.gftt_candidates(jnp.asarray(left), jnp.float32(0.01), 3,
                                   max_candidates=4096)
    kj, vj, nj = J.select_from_candidates_device(
        v, i, w, jnp.float32(7.0), max_features=1500, capacity=1536)
    kt, vt, nt = T.select_from_candidates_device(
        torch.as_tensor(np.array(v))[None],
        torch.as_tensor(np.array(i)).long()[None], w, 7.0,
        max_features=1500, capacity=1536)
    assert int(nt[0]) == int(nj) > 200
    np.testing.assert_array_equal(vt[0].numpy(), np.asarray(vj))
    np.testing.assert_array_equal(kt[0].numpy(), np.asarray(kj))


def test_nms_small_capacity_and_cap():
    """Fewer candidates than capacity, max_features binding."""
    rng = np.random.default_rng(3)
    n = 512
    vals = np.sort(rng.random(n).astype(np.float32))[::-1].copy()
    vals[400:] = -np.inf
    idx = rng.choice(120 * 90, n, replace=False).astype(np.int32)
    kj, vj, nj = J.select_from_candidates_device(
        jnp.asarray(vals), jnp.asarray(idx), 120, jnp.float32(7.0),
        max_features=50, capacity=600)
    kt, vt, nt = T.select_from_candidates_device(
        torch.as_tensor(vals)[None], torch.as_tensor(idx).long()[None],
        120, 7.0, max_features=50, capacity=600)
    assert int(nt[0]) == int(nj) == 50
    np.testing.assert_array_equal(kt[0].numpy(), np.asarray(kj))


@pytest.mark.parametrize("block, inside", [(3, True), (5, False)])
def test_dispatch_choice_on_the_card(block, inside):
    """gftt_candidates sends a CUDA image to K2 exactly when k2_refusal is
    None (block 3), through _cuda.on_kernel; another block size takes the
    plain path on the card; a CPU image always the plain path, which is
    tpuslam's XLA path at that block size."""
    from types import SimpleNamespace
    from tpuslam_torch.kernels import _cuda
    assert (T.k2_refusal(block) is None) == inside
    assert _cuda.on_kernel(SimpleNamespace(is_cuda=True),
                           T.k2_refusal(block)) == inside
    img = np.random.default_rng(block).integers(0, 256, (240, 320)) \
        .astype(np.uint8)
    assert not _cuda.on_kernel(torch.as_tensor(img), T.k2_refusal(block))
    _cuda.reset_counters()
    vals, idx, maxv, n = T.gftt_candidates(torch.as_tensor(img)[None],
                                           0.01, block, 64)
    assert _cuda.PLAIN_CALLS["gftt"] == 1 and _cuda.LAUNCHES["gftt"] == 0
    jv, ji, jm, jn = J.gftt_candidates(jnp.asarray(img), jnp.float32(0.01),
                                       block, 64)
    assert int(n[0]) == int(jn)
    np.testing.assert_array_equal(idx[0].numpy()[:int(jn)],
                                  np.asarray(ji)[:int(jn)])
