"""tpuslam_torch's pose graph and bundle adjustment against tpuslam's.

The pose graph's host backend is numpy/scipy in f64 in both packages and
the port's is a copy: the same graph gives the same poses and chi2, bit
for bit (its device backends: tests/test_torch_device_opt.py).  Bundle
adjustment runs in f32 in both (torch here, XLA there);
the sums are taken in another order, so the port is held to
tests/test_ba.py's tolerances: rms < 1e-3 px and camera translations
within 1e-3 of the truth on a noise-free problem, with the port's and
tpuslam's solutions within the same 1e-3 of each other; on a drifted
trajectory, where 15 LM steps amplify f32 rounding into centimetres,
global BA must cut the ATE below 0.3x the drift (test_ba.py) and end
within 1 cm of tpuslam's ATE.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuslam_torch import convert


def _graph(seed):
    """A 24-node trajectory with drifted odometry links, two good loop
    edges and one bad loop edge (tpuslam's own classes)."""
    from tpuslam.geometry.transform import from_rpy_xyz, compose, inverse
    from tpuslam.mapping.graph import Link, MultiMap, NEIGHBOR, LOOP_CLOSURE
    rng = np.random.default_rng(seed)
    n = 24
    gt = [np.eye(4, dtype=np.float32)]
    for i in range(1, n):
        ang = 2 * np.pi * i / n
        gt.append(from_rpy_xyz(5 * np.cos(ang), 5 * np.sin(ang), 0.0, 0.0,
                               0.0, ang + np.pi / 2))
    poses, links = {}, MultiMap()
    cur = gt[0]
    info = np.diag([100.0] * 3 + [400.0] * 3)
    for i in range(n):
        poses[i + 1] = cur.copy()
        if i + 1 < n:
            rel = compose(inverse(gt[i]), gt[i + 1])
            noisy = compose(rel, from_rpy_xyz(*rng.normal(0, 0.02, 6)))
            links.insert(i + 1, Link(i + 1, i + 2, NEIGHBOR, noisy, info))
            cur = compose(cur, noisy)
    for a, b in ((1, 24), (3, 22)):
        links.insert(b, Link(b, a, LOOP_CLOSURE,
                             compose(inverse(gt[b - 1]), gt[a - 1]), info))
    bad = compose(inverse(gt[15]), gt[5])
    bad = compose(bad, from_rpy_xyz(3.0, -2.0, 0.5, 0.2, 0.0, 0.4))
    links.insert(16, Link(16, 6, LOOP_CLOSURE, bad, info))
    return poses, links


@pytest.mark.parametrize("seed", [0, 1])
def test_robust_pose_graph_equal(seed):
    from tpuslam.config import OptimizerConfig as JCfg
    from tpuslam.optim import run_optimize_robust as j_robust
    from tpuslam_torch.config import OptimizerConfig
    from tpuslam_torch.optim import run_optimize_robust
    poses, links = _graph(seed)
    ref, ref_chi2 = j_robust(poses, links, 20, JCfg())
    tp, tl = convert.graph_from_reference(poses, links)
    got, chi2 = run_optimize_robust(tp, tl, 20, OptimizerConfig())
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert chi2 == ref_chi2
    # the bad loop edge was ejected: the result closes the loop
    assert np.linalg.norm(got[24][:3, 3] - got[1][:3, 3]) < 5.0


def _problem():
    import test_ba
    return test_ba._make_problem()


def test_ba_solve_matches_reference():
    from tpuslam.optim.ba import ba_solve as j_solve
    from tpuslam_torch.optim.ba import ba_solve
    (intr, Tcw_true, _, Tcw0, lms0, oc, ol, uv, valid) = _problem()
    Tj, lj, cj = j_solve(jnp.asarray(Tcw0), jnp.asarray(lms0),
                         jnp.asarray(intr), jnp.asarray(oc), jnp.asarray(ol),
                         jnp.asarray(uv), jnp.asarray(valid), n_cams=6,
                         n_lms=80, iterations=8, n_fixed=2)
    Tt, lt, ct = ba_solve(*(torch.as_tensor(x) for x in (
        Tcw0, lms0, intr, oc.astype(np.int64), ol.astype(np.int64), uv,
        valid)), n_cams=6, n_lms=80, iterations=8, n_fixed=2)
    assert np.sqrt(float(ct) / len(oc)) < 1e-3
    t_err = np.linalg.norm(Tt.numpy()[:, :3, 3] - Tcw_true[:, :3, 3], axis=1)
    assert t_err.max() < 1e-3
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-3)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-3)


@pytest.mark.parametrize("drift", [0.05, 0.0])
def test_global_ba_matches_reference(kitti_camera, drift):
    """refine_trajectory_global_ba on test_ba.py's fake mapper: the
    drifted trajectory is repaired as tpuslam repairs it, and the clean
    one stays a near no-op on which both packages agree to 1e-3 m."""
    import test_ba
    from tpuslam.geometry.kitti_metric import ate_rmse
    from tpuslam.mapping.ba_window import refine_trajectory_global_ba as jg
    from tpuslam_torch.mapping.ba_window import refine_trajectory_global_ba
    mk = test_ba.TestBAWindow()
    mapper, gt, _ = mk._fake_mapper(kitti_camera, n_nodes=20,
                                    pose_noise=0.0, seed=2 if drift else 3,
                                    drift=drift)
    poses = {nid: mapper.nodes[nid].pose for nid in mapper.nodes}
    ref = jg(mapper, poses, kitti_camera)
    got = refine_trajectory_global_ba(
        mapper, poses, convert.camera_from_reference(kitti_camera),
        device="cpu")
    assert sorted(got) == sorted(ref)
    gt_arr = np.stack(gt)

    def ate(p):
        return ate_rmse(gt_arr, np.stack([p[i + 1] for i in range(20)]))

    if drift:
        assert ate(got) < 0.3 * ate(poses)
        assert ate(got) <= ate(ref) + 0.01, (ate(got), ate(ref))
    else:
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-3)
        assert ate(got) <= ate(poses) + 0.02


def test_window_ba_matches_reference(kitti_camera):
    """refine_trajectory_ba (sliding windows) on test_ba.py's noisy fake
    mapper: it halves the worst pose error (test_ba.py's criterion), and
    ends no worse than tpuslam's by more than 1 mm (the windows' LM steps
    move the two f32 solutions a few mm apart)."""
    import test_ba
    from tpuslam.mapping.ba_window import refine_trajectory_ba as jw
    from tpuslam_torch.mapping.ba_window import refine_trajectory_ba
    mapper, gt, noisy = test_ba.TestBAWindow()._fake_mapper(kitti_camera)
    poses = {nid: mapper.nodes[nid].pose for nid in mapper.nodes}
    kw = dict(window=6, stride=3, iterations=10)
    ref = jw(mapper, poses, kitti_camera, **kw)
    got = refine_trajectory_ba(mapper, poses,
                               convert.camera_from_reference(kitti_camera),
                               device="cpu", **kw)
    assert sorted(got) == sorted(ref)

    def worst(p):
        return max(np.linalg.norm(p[i][:3, 3] - gt[i][:3, 3])
                   for i in range(len(gt)))

    before = worst(noisy)
    assert worst([got[i + 1] for i in range(len(gt))]) < before * 0.5
    assert worst([got[i + 1] for i in range(len(gt))]) <= \
        worst([ref[i + 1] for i in range(len(gt))]) + 1e-3


def test_connected_graph_rebuild_fault_matches_reference():
    """tpuslam's get_connected_graph (the port's is a copy) keys each link
    of its output under the vertex the walk reached it from.  On the chain
    1-5 with loop closures 4 -> 1 and 5 -> 3 the closure 5 -> 3 ends up
    under its `to` vertex only, so a second rebuild (a second robust
    round) cannot find it and raises AttributeError, in both packages
    alike (ROADMAP C)."""
    import tpuslam.mapping.graph as JG
    import tpuslam_torch.mapping.graph as TG
    out = {}
    for G in (JG, TG):
        links = G.MultiMap()
        eye = np.eye(4, dtype=np.float32)
        for i in range(1, 5):
            links.insert(i, G.Link(i, i + 1, G.NEIGHBOR, eye, np.eye(6)))
        for a, b in ((4, 1), (5, 3)):
            links.insert(a, G.Link(a, b, G.LOOP_CLOSURE, eye, np.eye(6)))
        poses = {i: eye for i in range(1, 6)}
        p1, l1 = G.get_connected_graph(1, poses, links)
        out[G] = [(k, lk.from_id, lk.to_id) for k, lk in l1.items()]
        assert (3, 5, 3) in out[G] and all(
            k != 5 for k, f, t in out[G] if (f, t) == (5, 3))
        with pytest.raises(AttributeError):
            G.get_connected_graph(1, p1, l1)
    assert out[TG] == out[JG]
