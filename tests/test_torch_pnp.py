"""tpuslam_torch EPnP / RANSAC / LM refine against tpuslam's.

The port keeps the JAX version's unrolled f32 operation order; what
differs is the summation order inside library reductions and matmuls and
the last ulp of transcendentals (acos, cos, sin).  EPnP poses therefore
agree to atol 1e-4 on well-conditioned problems (f32 reduction order),
and RANSAC, fed tpuslam's own hypothesis draws, picks the same best
hypothesis with the same inlier mask.  The LM refine (the plain version
of kernel K6) is held to the JAX suite's own Pallas-vs-XLA tolerance
(tests/test_pnp.py:127-133): rvec 1e-5, tvec 1e-4, the same inliers at
2 px; so is the host solve_pnp_ransac driver.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tpuslam.kernels import pnp as J
from tpuslam_torch.kernels import pnp as T


def _rot(rng):
    w = rng.normal(0, 0.3, 3)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _problem(rng, n, noise=0.0):
    R = _rot(rng)
    t = rng.normal(0, 0.5, 3)
    pc = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                   rng.uniform(6, 30, n)], 1)
    pw = (pc - t) @ R          # pc = R pw + t
    img_n = pc[:, :2] / pc[:, 2:3] + rng.normal(0, noise, (n, 2))
    return pw.astype(np.float32), img_n.astype(np.float32), R, t


def test_epnp_norm_matches(rng):
    probs = [_problem(rng, 6) for _ in range(16)]
    obj = np.stack([p[0] for p in probs])
    img = np.stack([p[1] for p in probs])
    Rt, tt, okt = T.epnp_norm(torch.as_tensor(obj), torch.as_tensor(img))
    Rj, tj, okj = jax.vmap(J.epnp_norm)(jnp.asarray(obj), jnp.asarray(img))
    assert okt.all() and np.asarray(okj).all()
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-4)
    # and both recover the true pose
    for b, (_, _, R, t) in enumerate(probs):
        np.testing.assert_allclose(Rt[b].numpy(), R, atol=1e-3)
        np.testing.assert_allclose(tt[b].numpy(), t, atol=1e-2)


def test_rodrigues_roundtrip_matches(rng):
    for _ in range(8):
        R = _rot(rng).astype(np.float32)
        rv_t = T.rodrigues_inv(torch.as_tensor(R))
        rv_j = np.asarray(J.rodrigues_inv(jnp.asarray(R)))
        np.testing.assert_allclose(rv_t.numpy(), rv_j, atol=1e-6)
        np.testing.assert_allclose(T.rodrigues(rv_t).numpy(),
                                   np.asarray(J.rodrigues(jnp.asarray(rv_j))),
                                   atol=1e-6)


@pytest.mark.parametrize("frame", [0, 7])
def test_ransac_same_best_hypothesis(rng, frame):
    N, nv = 384, 300
    K = np.array([[700.0, 0, 620.0], [0, 700.0, 188.0], [0, 0, 1]],
                 np.float32)
    pw, img_n, R, t = _problem(rng, N, noise=4e-4)
    img = img_n * K[[0, 1], [0, 1]] + K[[0, 1], [2, 2]]
    out = rng.uniform(size=N) < 0.2                    # 20% outliers
    img[out] += rng.uniform(-60, 60, (out.sum(), 2)).astype(np.float32)
    valid = np.zeros(N, bool)
    valid[rng.choice(N, nv, replace=False)] = True
    key = jax.random.PRNGKey(frame)
    rj, tj, inl_j, n_j = J.ransac_epnp(
        jnp.asarray(pw), jnp.asarray(img), jnp.asarray(valid),
        jnp.asarray(K), key, jnp.float32(2.0), n_hyp=300)
    draws = np.array(jax.random.uniform(key, (300, 6)))
    rt, tt, inl_t, n_t = T.ransac_epnp(
        torch.as_tensor(pw), torch.as_tensor(img), torch.as_tensor(valid),
        torch.as_tensor(K), torch.as_tensor(draws), 2.0, n_hyp=300)
    assert int(n_t) == int(n_j) > 150
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)


def test_ransac_rejects_bad_draws_shape():
    with pytest.raises(ValueError):
        T.ransac_epnp(torch.zeros(8, 3), torch.zeros(8, 2),
                      torch.ones(8, dtype=torch.bool), torch.eye(3),
                      torch.zeros(10, 6), 2.0, n_hyp=300)


K_PX = np.array([[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157],
                 [0.0, 0.0, 1.0]], np.float32)


def _refine_case(rng, case):
    n = 300
    pw, img_n, R, t = _problem(rng, n, noise=4e-4)
    img = img_n * K_PX[[0, 1], [0, 1]] + K_PX[[0, 1], [2, 2]]
    rv_true = np.asarray(J.rodrigues_inv(jnp.asarray(R.astype(np.float32))))
    w = (rng.uniform(size=n) < 0.7).astype(np.float32)
    if case == "zero_weight_rows":
        w[:100] = 0.0
    rv0 = np.zeros(3, np.float32) if case == "zero_rvec" else rv_true + 0.05
    return (pw, img.astype(np.float32), w, w > 0, K_PX,
            rv0.astype(np.float32), (t + 0.3).astype(np.float32))


@pytest.mark.parametrize("case", ["perturbed", "zero_rvec",
                                  "zero_weight_rows"])
def test_refine_lm_with_errors_matches(rng, case):
    args = _refine_case(rng, case)
    rj, tj, ej = J.refine_lm_with_errors(*(jnp.asarray(a) for a in args))
    rt, tt, et = T.refine_lm_with_errors(*(torch.as_tensor(a)
                                           for a in args))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(et.numpy() <= 2.0, np.asarray(ej) <= 2.0)
    assert (et.numpy() <= 2.0).sum() > 0.9 * (args[2] > 0).sum()
    if case == "perturbed":
        # and the Pallas kernel K6 replaces, interpreted on the CPU
        rp, tp, ep = J.refine_lm_errors_pallas(
            *(jnp.asarray(a) for a in args), interpret=True)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rp), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tp), rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(et.numpy() <= 2.0,
                                      np.asarray(ep) <= 2.0)


def test_refine_dispatch_plain_on_cpu(rng):
    from tpuslam_torch.kernels import _cuda
    args = [torch.as_tensor(a) for a in _refine_case(rng, "perturbed")]
    _cuda.reset_counters()
    T.refine_lm_with_errors_auto(*args)
    assert _cuda.PLAIN_CALLS["lm_refine"] == 1
    assert sum(_cuda.LAUNCHES.values()) == 0


def test_normal_eqs_translation_block(rng):
    """du/dty and dv/dtx are 0, so the plain version's H[tx, ty] is
    exactly 0: kernel K6 leaves those products out of its sums."""
    obj, img_n, _, _ = _problem(rng, 200, noise=0.01)
    w = torch.as_tensor((rng.uniform(size=200) < 0.7).astype(np.float32))
    p = torch.as_tensor(rng.normal(0, 0.2, 6).astype(np.float32))
    H, _, _ = T._normal_eqs(torch.as_tensor(obj), torch.as_tensor(img_n),
                            w, p)
    assert float(H[3, 4]) == 0.0 and float(H[4, 3]) == 0.0
    assert float(H[3, 3]) > 0.0


def test_lm_block_sweep_needs_the_card(monkeypatch):
    from tpuslam_torch.tools import lm_block_sweep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        lm_block_sweep.main([])


@pytest.mark.parametrize("seed", [0, 5])
def test_solve_pnp_ransac_matches(rng, seed):
    """The host driver with tpuslam's own draws (PRNGKey(seed)): the same
    inliers and, after the refine round, the same pose to 1e-5 / 1e-4.
    Capacity 384 shares tpuslam's RANSAC compile with the test above."""
    n = 360
    pw, img_n, R, t = _problem(rng, n, noise=4e-4)
    img = (img_n * K_PX[[0, 1], [0, 1]] + K_PX[[0, 1], [2, 2]])
    out = rng.uniform(size=n) < 0.25
    img[out] += rng.uniform(-80, 80, (out.sum(), 2))
    img = img.astype(np.float32)
    z3 = np.zeros(3, np.float32)
    rj, tj, ij = J.solve_pnp_ransac(pw, img, K_PX, z3, z3, seed=seed,
                                    capacity=384)
    draws = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (300, 6)))
    rt, tt, it = T.solve_pnp_ransac(pw, img, K_PX, z3, z3, seed=seed,
                                    capacity=384, device="cpu", draws=draws)
    np.testing.assert_array_equal(it, ij)
    assert len(it) > 220 and not set(it) & set(np.nonzero(out)[0])
    np.testing.assert_allclose(rt, np.asarray(rj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt, np.asarray(tj), rtol=0, atol=1e-4)


def test_solve_pnp_ransac_failure_returns_guess(rng):
    pts = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    img = rng.uniform(0, 100, (5, 2)).astype(np.float32)
    rv0 = np.array([1, 2, 3], np.float32)
    tv0 = np.array([4, 5, 6], np.float32)
    rvec, tvec, inl = T.solve_pnp_ransac(pts, img, K_PX, rv0, tv0,
                                         device="cpu")
    np.testing.assert_array_equal(rvec, rv0)
    np.testing.assert_array_equal(tvec, tv0)
    assert len(inl) == 0
