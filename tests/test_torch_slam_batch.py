"""tpuslam_torch's per-frame path (runtime/pipeline.py, vo/odometry.py)
and batch app (cli/slam_batch.py) against tpuslam's.

`Odometry`'s state machine is held exactly with a scripted registration.
The whole path runs on a 6-frame 320x240 tpuslam-written sequence (f =
250, as test_torch_fused.py) in SlamConfig() with a small Mapper that
closes a loop, tpuslam's RANSAC draws injected into the port.
Tolerances:
- disparity: the port's is cv2.filterSpeckles of tpuslam's unspeckled
  disparity, bit for bit; tpuslam's 16 speckle rounds do not converge on
  these frames, so it differs from the port only where it filtered more
  (test_torch_speckle.py);
- keypoints exact, their responses and the descriptors as
  test_torch_gftt.py and test_torch_orb.py hold them: XLA's CPU backend
  contracts FMAs in the GFTT response and the ORB blur (rtol 2e-6; a
  blurred pixel may move by one level and flip a test bit);
- 3D points to 1e-5 m where both disparities agree;
- lost and keyframe flags equal, inliers within 2, VO and optimized
  translations within 1e-3 m (registration noise, as test_torch_fused.py);
- graph sizes and output files equal, occupied voxels within 1 % (the
  speckle difference moves a few voxels);
- checkpoints: a file written by either package loads in the other with
  every field equal; a resumed run equals the straight run bit for bit
  (the RANSAC seeds, frames_processed and node ids, are restored), as
  tests/test_runtime.py:89-113 requires of tpuslam;
- the pose-graph replay (host backend, a copy) equals tpuslam's bit for
  bit.
"""

import dataclasses
import os

import cv2
import jax
import numpy as np
import pytest

from tpuslam.config import SlamConfig, MapperConfig
from tpuslam_torch import convert


OUTPUTS = ("map_poses.csv", "map_links.csv", "optimized_poses.csv",
           "slam.bt", "perf_time.csv")


def _jax_draws(seed):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (300, 6)))


# --- Odometry's state machine, with a scripted registration ---------------

# per registration call: (transform step or None, matches, inliers); the
# calls of frames 1-6: found; a wrong guess (40 < 0.25 * 200) retried
# without it; lost twice (guess, then retry); found after the loss with a
# zero-velocity guess; found with few inliers (a keyframe); found
SCRIPT = [((0.01, 0, 0.002, 0.4, 0, 0.0), 200, 180),
          ((0.02, 0, 0.0, 0.5, 0, 0.0), 40, 30),
          ((0.0, 0.01, 0.001, 0.45, 0, 0.01), 190, 140),
          (None, 10, 0), (None, 5, 0),
          ((0.0, 0, 0.003, 0.9, 0.02, 0.0), 300, 280),
          ((0.01, 0, 0.0, 0.4, 0, 0.0), 280, 100),
          ((0.0, 0, 0.0, 0.41, 0, 0.0), 290, 270)]
N_KPTS = [500, 480, 470, 460, 450, 440, 430]


def _scripted_run(monkeypatch, pkg):
    """Odometry of `pkg` over 7 frames against SCRIPT -> (infos, calls:
    whether each call had a guess)."""
    import importlib
    odo = importlib.import_module(f"{pkg}.vo.odometry")
    reg = importlib.import_module(f"{pkg}.vo.registration")
    frame_mod = importlib.import_module(f"{pkg}.vo.frame")
    tr = importlib.import_module(f"{pkg}.geometry.transform")
    calls = []

    def fake(frame_from, frame_to, guess, camera, **kw):
        step, matches, inliers = SCRIPT[len(calls)]
        calls.append(guess is not None)
        info = reg.RegInfo(covariance=np.eye(6) * (len(calls) + 1),
                           num_matches=matches, num_inliers=inliers)
        return (None if step is None else tr.from_rpy_xyz(*step)), info

    monkeypatch.setattr(odo, "compute_transform", fake)
    cam = _camera(240, 320)
    kw = {} if pkg == "tpuslam" else dict(device="cpu")
    o = odo.Odometry(cam, **kw)
    infos = []
    for i, n in enumerate(N_KPTS):
        frame = frame_mod.Frame(stamp=0.1 * i,
                                kpts=np.zeros((n, 3), np.float32))
        infos.append(o.process(frame))
    assert len(calls) == len(SCRIPT)
    return infos, calls


def test_odometry_state_machine_scripted(monkeypatch):
    """OdomInfo equal field by field over found, wrong-guess retry, lost,
    recovery and keyframe switches; the same calls with the same guesses."""
    ref, ref_calls = _scripted_run(monkeypatch, "tpuslam")
    got, got_calls = _scripted_run(monkeypatch, "tpuslam_torch")
    assert got_calls == ref_calls == [False, True, False, True, False,
                                      True, True, True]
    assert [i.lost for i in got] == [False, False, False, True, False,
                                     False, False]
    assert [i.keyframe_added for i in got] == [True, False, True, True,
                                               False, True, False]
    for a, b in zip(got, ref):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if y is None:
                assert x is None, f.name
            else:
                np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_odometry_draws_fn_and_device(monkeypatch):
    """The RANSAC draws come from draws_fn(frames_processed) and the
    registration runs on the Odometry's device."""
    from tpuslam_torch.vo import odometry as O
    from tpuslam_torch.vo.frame import Frame
    seen = []

    def fake(*args, **kw):
        seen.append((kw["seed"], kw["device"], kw["draws"]))
        return None, O.RegInfo()

    monkeypatch.setattr(O, "compute_transform", fake)
    o = O.Odometry(_camera(240, 320), device="cpu",
                   draws_fn=lambda s: ("draws", s))
    for i in range(3):
        o.process(Frame(stamp=0.1 * i))
    assert seen[0] == (1, "cpu", ("draws", 1))
    assert all(s[2] == ("draws", s[0]) for s in seen)


# --- the whole path -------------------------------------------------------

def _camera(h, w, f=250.0, baseline=0.54):
    from tpuslam_torch.io.synthetic import sequence_camera
    return sequence_camera(w, h, f, baseline)


def _cfg():
    return dataclasses.replace(SlamConfig(), mapper=MapperConfig(
        map_update=2, max_stm_size=2, loop_thr=0.05))


def _recording(monkeypatch, module, frames, infos, odoms=None):
    """Record the Frame and the OdomInfo of every frame of a run(), and in
    `odoms` its Odometry."""
    extract, process = module.extract_features, module.Odometry.process

    def rec_frame(*args, **kw):
        frames.append(extract(*args, **kw))
        return frames[-1]

    def rec_info(self, frame):
        if odoms is not None and not odoms:
            odoms.append(self)
        infos.append(process(self, frame))
        return infos[-1]
    monkeypatch.setattr(module, "extract_features", rec_frame)
    monkeypatch.setattr(module.Odometry, "process", rec_info)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tpuslam's and the port's run() over one sequence, each with its
    frames; the port's plain-version counts; tpuslam's unspeckled
    disparity per frame."""
    from tpuslam.cli import slam_batch as JB
    from tpuslam.io.synthetic import make_sequence
    from tpuslam.kernels.stereo_bm import stereo_bm
    from tpuslam_torch.cli import slam_batch as TB
    from tpuslam_torch.kernels import _cuda
    seq = str(tmp_path_factory.mktemp("batch_seq"))
    make_sequence(seq, n_frames=6, width=320, height=240, f=250.0,
                  baseline=0.54, speed=0.4, yaw_rate=0.002, seed=3)
    jf, tf, ji, ti, jo, to = [], [], [], [], [], []
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, JB, jf, ji, jo)
        _recording(mp, TB, tf, ti, to)
        ref = JB.run(seq, _cfg(), quiet=True,
                     out_dir=os.path.join(seq, "jax"))
        _cuda.reset_counters()
        got = TB.run(seq, convert.config_from_reference(_cfg()),
                     quiet=True, out_dir=os.path.join(seq, "port"),
                     device="cpu", draws_fn=_jax_draws)
        plain = dict(_cuda.PLAIN_CALLS)
    raw = [np.asarray(stereo_bm(f.image_left, f.image_right, _cfg().bm,
                                with_speckle=False)) for f in jf]
    return dict(seq=seq, ref=ref, got=got, jf=jf, tf=tf, ji=ji, ti=ti,
                raw=raw, plain=plain, j_odom=jo[0], t_odom=to[0])


def test_frontend_matches_reference(runs):
    bm = _cfg().bm
    for j, t, raw in zip(runs["jf"], runs["tf"], runs["raw"]):
        want = raw.copy()
        cv2.filterSpeckles(want, (bm.min_disparity - 1) * 16,
                           bm.speckle_window_size, bm.speckle_range)
        np.testing.assert_array_equal(t.disparity, want)
        diff = j.disparity != t.disparity
        assert (j.disparity[diff] == -16).all()
        assert (t.disparity[diff] != -16).all()
        np.testing.assert_array_equal(t.kpts[:, :2], j.kpts[:, :2])
        np.testing.assert_allclose(t.kpts[:, 2], j.kpts[:, 2], rtol=2e-6,
                                   atol=1e-7)
        assert t.desc.shape == j.desc.shape
        flipped = np.unpackbits(t.desc ^ j.desc, axis=1).sum(axis=1)
        assert (flipped <= 2).all() and (flipped > 0).mean() < 0.01
        xs = t.kpts[:, 0].astype(int)
        ys = t.kpts[:, 1].astype(int)
        same = t.disparity[ys, xs] == j.disparity[ys, xs]
        np.testing.assert_array_equal(np.isnan(t.kpts3d[same]),
                                      np.isnan(j.kpts3d[same]))
        np.testing.assert_allclose(t.kpts3d[same], j.kpts3d[same],
                                   rtol=0, atol=1e-5)


def test_trajectory_matches_reference(runs):
    ref, got = runs["ref"], runs["got"]
    assert got["n_frames"] == ref["n_frames"] == 6
    np.testing.assert_allclose(got["vo_poses"][:, :3, 3],
                               ref["vo_poses"][:, :3, 3], rtol=0, atol=1e-3)
    assert sorted(got["optimized"]) == sorted(ref["optimized"])
    for k in ref["optimized"]:
        np.testing.assert_allclose(got["optimized"][k][:3, 3],
                                   ref["optimized"][k][:3, 3], rtol=0,
                                   atol=1e-3)
    assert abs(got["ate_m"] - ref["ate_m"]) < 1e-3


def test_odometry_flags_match_reference(runs):
    """Per frame: lost and keyframe flags equal, inliers and matches
    within 2; the Mapper's nodes have the same weights and links."""
    ji, ti = runs["ji"], runs["ti"]
    assert len(ti) == len(ji) == 6
    assert [i.lost for i in ti] == [i.lost for i in ji]
    assert not any(i.lost for i in ti)
    assert [i.keyframe_added for i in ti] == [i.keyframe_added for i in ji]
    for a, b in zip(ti, ji):
        assert abs(a.num_inliers - b.num_inliers) <= 2
        assert abs(a.num_matches - b.num_matches) <= 2
    mj, mt = runs["ref"]["mapper"], runs["got"]["mapper"]
    assert sorted(mj.nodes) == sorted(mt.nodes)
    for nid in mj.nodes:
        a, b = mj.nodes[nid], mt.nodes[nid]
        assert a.weight == b.weight
        assert sorted(k for k, _ in a.links.items()) == \
            sorted(k for k, _ in b.links.items())


def test_graph_and_outputs_match_reference(runs):
    ref, got, seq = runs["ref"], runs["got"], runs["seq"]
    for k in ("n_nodes", "n_links", "n_loop_closures"):
        assert got[k] == ref[k], k
    assert got["n_loop_closures"] >= 1
    assert got["mapper"].loop_closures == ref["mapper"].loop_closures
    for name in OUTPUTS:
        a = os.path.join(seq, "jax", name)
        b = os.path.join(seq, "port", name)
        assert os.path.exists(b), name
        if name.endswith(".csv"):
            assert len(open(b).readlines()) == len(open(a).readlines())
    assert open(os.path.join(seq, "port", "perf_time.csv")).readline() == \
        open(os.path.join(seq, "jax", "perf_time.csv")).readline()
    n_j, n_t = ref["n_occupied_voxels"], got["n_occupied_voxels"]
    assert n_t > 0 and abs(n_t - n_j) <= 0.01 * n_j


def test_port_took_the_plain_versions(runs):
    """On the CPU the path ran every kernel's plain version: K1, K5, K2,
    K3 once per frame, K6 per refined registration (VO and loop closure),
    K4 never."""
    plain = runs["plain"]
    for k in ("stereo_bm", "lr_check", "gftt", "orb"):
        assert plain[k] == 6, (k, plain)
    assert plain["median"] == 0
    assert plain["lm_refine"] >= 5 + runs["got"]["n_loop_closures"]


# --- the multi-process back end over this run's stream ---------------------

def _features(frames, cap=1536):
    """The frames' features laid out as dist/multihost.py gathers them."""
    n = len(frames)
    feats = dict(kpts=np.zeros((n, cap, 3), np.float32),
                 pts3d=np.zeros((n, cap, 3), np.float32),
                 desc=np.zeros((n, cap, 32), np.uint8),
                 n_kpts=np.zeros((n,), np.int32))
    for i, f in enumerate(frames):
        k = len(f.kpts)
        feats["kpts"][i, :k] = f.kpts
        feats["pts3d"][i, :k] = f.kpts3d
        feats["desc"][i, :k] = f.desc
        feats["n_kpts"][i] = k
    return feats, np.array([f.stamp for f in frames])


def _reference_camera(cam):
    from tpuslam.geometry.camera import StereoCameraModel
    return StereoCameraModel(P_l=cam.P_l, P_r=cam.P_r, width=cam.width,
                             height=cam.height)


def test_vo_from_features_matches_reference(runs):
    """dist/multihost.vo_from_features over the port's run's features,
    tpuslam's draws injected, against tpuslam's on the same features
    (translations within 1e-3 m, as the trajectories above), and equal to
    the batch app's own VO on those frames bit for bit."""
    from tpuslam.dist import multihost as J
    from tpuslam_torch.dist import multihost as T
    feats, stamps = _features(runs["tf"])
    cam = runs["t_odom"].camera
    ref = J.vo_from_features(feats, stamps, _reference_camera(cam), _cfg())
    record = []
    got = T.vo_from_features(feats, stamps, cam,
                             convert.config_from_reference(_cfg()),
                             device="cpu", draws_fn=_jax_draws,
                             record=record)
    np.testing.assert_allclose(got[:, :3, 3], ref[:, :3, 3], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(got, np.stack(runs["got"]["vo_poses"]))
    assert [i.num_inliers for _, i in record] == \
        [i.num_inliers for i in runs["ti"]]


def _likelihood_recording(pkg_mapper, trace, method):
    """A subclass of `pkg_mapper` that appends (node id, sorted
    likelihoods) of every loop-closure query to `trace`."""
    class Recording(pkg_mapper):
        pass

    def rec(self, node, ids):
        lik = getattr(pkg_mapper, method)(self, node, ids)
        trace.append((node.id, sorted(lik.items())))
        return lik
    setattr(Recording, method, rec)
    return Recording


def test_partitioned_mapper_matches_reference(runs):
    """Two ranks of the port's PartitionedMapper in thread lock-step over
    the port's run's frames and odometry, tpuslam's draws injected: the
    same loop closures, node words, links and link transforms as the
    port's Mapper bit for bit and likelihoods to rtol 1e-12; the same
    words, owned shards, loop closures and links as tpuslam's
    PartitionedMapper pair, its loop-closure transforms to registration
    noise (1e-4, as test_torch_mapping.py holds them)."""
    import copy
    from tpuslam.dist.partitioned_map import PartitionedMapper as JPM
    from tpuslam_torch.dist.partitioned_map import PartitionedMapper
    from tpuslam_torch.mapping.mapper import Mapper
    from tpuslam_torch.tools.dist_worker import links_flat, words_flat
    from test_torch_dist import ThreadComm, in_lockstep
    stream = list(zip(runs["tf"], runs["ti"]))
    cam = runs["t_odom"].camera
    cfg, tcfg = _cfg(), convert.config_from_reference(_cfg())

    sm_trace = []
    sm = _likelihood_recording(Mapper, sm_trace, "compute_likelihood")(
        cam, tcfg.mapper, tcfg.matching, tcfg.pnp, device="cpu")
    sm.draws_fn = _jax_draws
    for frame, info in stream:
        sm.process(frame, info)
    assert sm.loop_closures, "the stream must close a loop"

    traces = [[], []]
    tcomm, jcomm = ThreadComm(2), ThreadComm(2)

    def ranks(rank):
        pm = _likelihood_recording(PartitionedMapper, traces[rank],
                        "_likelihood_allreduce")(
            cam, tcfg.mapper, tcfg.matching, tcfg.pnp, rank=rank, world=2,
            comm=tcomm.make(rank), device="cpu")
        pm.draws_fn = _jax_draws
        jpm = JPM(_reference_camera(cam), cfg.mapper, cfg.matching,
                  cfg.pnp, rank=rank, world=2, comm=jcomm.make(rank))
        for frame, info in stream:
            pm.process(copy.copy(frame), info)
        for frame, info in stream:
            jpm.process(copy.copy(frame), info)
        return pm, jpm

    (p0, j0), (p1, j1) = in_lockstep(2, ranks)
    for pm, jpm in ((p0, j0), (p1, j1)):
        assert pm.loop_closures == sm.loop_closures == jpm.loop_closures
        np.testing.assert_array_equal(words_flat(pm), words_flat(sm))
        np.testing.assert_array_equal(words_flat(pm), words_flat(jpm))
        assert set(pm.vwd.words) == set(jpm.vwd.words)
        assert len(pm.vwd) == len(jpm.vwd) == len(sm.vwd)
        for a, b in zip(links_flat(pm), links_flat(sm)):
            np.testing.assert_array_equal(a, b)
        (rows, tfs), (jrows, jtfs) = links_flat(pm), links_flat(jpm)
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_allclose(tfs, jtfs, rtol=0, atol=1e-4)
    assert not set(p0.vwd.words) & set(p1.vwd.words)
    assert traces[0] == traces[1] and traces[0]
    assert [n for n, _ in traces[0]] == [n for n, _ in sm_trace]
    for (_, a), (_, b) in zip(traces[0], sm_trace):
        assert [c for c, _ in a] == [c for c, _ in b]
        np.testing.assert_allclose([v for _, v in a], [v for _, v in b],
                                   rtol=1e-12, atol=1e-14)


# --- checkpoints, resume and the replay -----------------------------------

def _frame_state(f):
    return [f.stamp, f.frame_id, f.kpts, f.kpts3d, f.desc, f.disparity_dec,
            f.disp_scale, f.gt_pose]


def _state(mapper, odom):
    """Every field a checkpoint holds, as plain values (either package)."""
    nodes = {}
    for i, n in sorted(mapper.nodes.items()):
        nodes[i] = [n.map_id, n.weight, np.asarray(n.pose), n.velocity,
                    list(n.words), _frame_state(n.frame),
                    [(lk.from_id, lk.to_id, lk.type, np.asarray(lk.transform),
                      np.asarray(lk.info)) for _, lk in n.links.items()]]
    v = mapper.vwd
    return dict(
        nodes=nodes, stm=list(mapper.stm), wm=dict(mapper.working_mem),
        counters=[mapper._id_count, mapper._id_map_count,
                  mapper._frame_processed, mapper._intermediate_count,
                  mapper._wm_counter, mapper.last_node.id],
        loop_closures=list(mapper.loop_closures),
        words={w: [vw.descriptor, dict(vw.references), vw.total_references]
               for w, vw in v.words.items()},
        dictionary=[v._last_word_id, v._count, v._train[:v._count],
                    v._word_ids[:v._count]],
        odom=[odom.pose, odom.velocity_guess, odom.previous_stamp,
              odom.frames_processed, odom.num_objects,
              odom.distance_travelled, odom.state, odom.last_keyframe_pose,
              _frame_state(odom.ref_frame)])


@pytest.mark.parametrize("direction", ["port_to_tpuslam", "tpuslam_to_port"])
def test_checkpoint_format_shared(runs, tmp_path, direction):
    """A checkpoint saved by one package (its Mapper and Odometry at the
    end of the fixture's run) loads into the other's fresh Mapper and
    Odometry with every field equal."""
    from tpuslam.mapping.mapper import Mapper as JMapper
    from tpuslam.runtime import checkpoint as JC
    from tpuslam.vo.odometry import Odometry as JOdometry
    from tpuslam_torch.mapping.mapper import Mapper as TMapper
    from tpuslam_torch.runtime import checkpoint as TC
    from tpuslam_torch.vo.odometry import Odometry as TOdometry
    path = str(tmp_path / "state.npz")
    jcfg, tcfg = _cfg(), convert.config_from_reference(_cfg())
    if direction == "port_to_tpuslam":
        mapper, odom = runs["got"]["mapper"], runs["t_odom"]
        TC.save_state(path, mapper, odom)
        cam = runs["ref"]["mapper"].camera
        m2 = JMapper(cam, jcfg.mapper, jcfg.matching, jcfg.pnp)
        o2 = JOdometry(cam, jcfg.odometry, jcfg.matching, jcfg.pnp)
        JC.load_state(path, m2, o2)
    else:
        mapper, odom = runs["ref"]["mapper"], runs["j_odom"]
        JC.save_state(path, mapper, odom)
        cam = runs["got"]["mapper"].camera
        m2 = TMapper(cam, tcfg.mapper, tcfg.matching, tcfg.pnp, device="cpu")
        o2 = TOdometry(cam, tcfg.odometry, tcfg.matching, tcfg.pnp,
                       device="cpu")
        TC.load_state(path, m2, o2)
        assert m2.vwd._dev_dirty and m2._lc_thread is None
    assert len(mapper.nodes) == 6 and len(mapper.vwd) > 0
    np.testing.assert_equal(_state(m2, o2), _state(mapper, odom))


@pytest.fixture(scope="module")
def resumed(runs, tmp_path_factory):
    """The port's run of the fixture's sequence cut after frame 2 with a
    checkpoint, then resumed to the end, on tpuslam's draws."""
    from tpuslam_torch.cli import slam_batch as TB
    d = str(tmp_path_factory.mktemp("resume"))
    cp = os.path.join(d, "cp.npz")
    cfg = convert.config_from_reference(_cfg())
    TB.run(runs["seq"], cfg, num_images=2, quiet=True, device="cpu",
           out_dir=os.path.join(d, "part1"), checkpoint_every=3,
           checkpoint_path=cp, draws_fn=_jax_draws)
    assert os.path.exists(cp)
    res = TB.run(runs["seq"], cfg, quiet=True, device="cpu",
                 out_dir=os.path.join(d, "part2"), resume_from=cp,
                 draws_fn=_jax_draws)
    return dict(cp=cp, res=res)


def _graph_signature(mapper):
    poses, links = mapper.get_graph()
    return dict(ids=sorted(poses),
                poses=np.concatenate([poses[i].ravel()
                                      for i in sorted(poses)]),
                links=sorted((lk.from_id, lk.to_id, lk.type)
                             for lk in links.values()),
                n_words=len(mapper.vwd),
                node_words={i: list(mapper.nodes[i].words)
                             for i in sorted(mapper.nodes)})


def test_resume_is_bit_identical(runs, resumed):
    """Frames 0-2, a checkpoint, then frames 3-5 from it: the Mapper's ids,
    poses, links, word count and node words and the VO poses equal the
    straight run's bit for bit (tests/test_runtime.py:89-113)."""
    straight, res = runs["got"], resumed["res"]
    np.testing.assert_equal(_graph_signature(res["mapper"]),
                            _graph_signature(straight["mapper"]))
    np.testing.assert_array_equal(res["vo_poses"], straight["vo_poses"])
    assert res["n_frames"] == 6 and len(res["vo_poses"]) == 6


def test_optimize_replay_equals_reference(runs, tmp_path):
    """The replay of the port's run's map CSVs: the port's (host backend,
    a copy) equals tpuslam's bit for bit, and its CSV is written."""
    from tpuslam.cli.optimize_replay import run as jreplay
    from tpuslam_torch.cli.optimize_replay import main, run as treplay
    out = os.path.join(runs["seq"], "port")
    args = (os.path.join(out, "map_poses.csv"),
            os.path.join(out, "map_links.csv"))
    gt = os.path.join(runs["seq"], "poses.txt")
    ref = jreplay(*args, gt_path=gt, quiet=True)
    got = treplay(*args, out_path=str(tmp_path / "opt.csv"), gt_path=gt,
                  quiet=True)
    assert sorted(got["optimized"]) == sorted(ref["optimized"])
    for k in ref["optimized"]:
        np.testing.assert_array_equal(got["optimized"][k],
                                      ref["optimized"][k])
    for k in ("chi2", "n_poses", "n_links", "ate_m"):
        assert got[k] == ref[k], k
    main(["-poses", args[0], "-links", args[1], "-out",
          str(tmp_path / "main.csv"), "-quiet"])
    assert open(tmp_path / "main.csv").read() == \
        open(tmp_path / "opt.csv").read()


@pytest.mark.parametrize("option", ["-device-opt", "-checkpoint-every",
                                    "-resume"])
def test_main_runs_ported_options(runs, resumed, tmp_path, option):
    """main() takes -device-opt (the pose graph's device back end, on the
    CPU here, after a resume to keep the run short), -checkpoint-every
    with -checkpoint, and -resume, and writes the batch app's outputs
    (and the checkpoint)."""
    from tpuslam_torch.cli.slam_batch import main
    from tpuslam_torch.runtime.checkpoint import FORMAT_VERSION
    out = str(tmp_path / "out")
    cp = str(tmp_path / "cp.npz")
    argv = {"-device-opt": ["-n", "3", "-resume", resumed["cp"],
                            "-device-opt"],
            "-checkpoint-every": ["-n", "1", "-checkpoint-every", "2",
                                  "-checkpoint", cp],
            "-resume": ["-n", "3", "-resume", resumed["cp"]]}[option]
    main(["-dir", runs["seq"], "-out", out, "-quiet", "-device", "cpu"] +
         argv)
    for name in OUTPUTS:
        assert os.path.exists(os.path.join(out, name)), name
    rows = len(open(os.path.join(out, "perf_time.csv")).readlines())
    assert rows == {"-device-opt": 2, "-checkpoint-every": 3,
                    "-resume": 2}[option]
    if option == "-checkpoint-every":
        z = np.load(cp)
        assert int(z["version"]) == FORMAT_VERSION
        assert list(z["node_ids"]) == [1, 2]
        assert int(z["odom_scalars"][1]) == 2


@pytest.mark.parametrize("method", ["sgbm", "lk", "cv_bm"])
def test_main_runs_every_depth_method(runs, tmp_path, method):
    """`-depth` takes every engine: main() over the first 3 frames on the
    CPU writes the batch app's outputs."""
    from tpuslam_torch.cli.slam_batch import main
    out = str(tmp_path / method)
    main(["-dir", runs["seq"], "-n", "2", "-out", out, "-quiet",
          "-depth", method, "-device", "cpu"])
    for name in OUTPUTS:
        assert os.path.exists(os.path.join(out, name)), name
    assert len(open(os.path.join(out, "perf_time.csv")).readlines()) == 4
