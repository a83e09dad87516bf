"""tpuslam_torch/dist (the device mesh, the sharded steps, the
multi-process VO, the partitioned map, cli/slam_multihost.py) against
tpuslam/dist, on the CPU.

tpuslam's steps run on a mesh of 4 of the conftest's 8 virtual CPU
devices, the port's on a CPU `Mesh` of 4 shards; inputs come from seeds
with numpy.  Tolerances:
- the front end: disparity bit for bit with the speckle pass off; with it
  on, cv2.filterSpeckles of tpuslam's unspeckled map, and tpuslam's own
  where its 16 rounds converge (tests/test_torch_speckle.py); the GFTT
  response to rtol 2e-6 (XLA's CPU backend contracts its FMAs, ROADMAP
  C); the blur bit for bit;
- the sharded pose-graph steps: chi2 rtol 2e-3 and translations 2e-2 m,
  the JAX suite's own (tests/test_dist.py:106-111, 172-177);
- the sharded BA: cost rtol 5e-2 and translations 5e-3
  (tests/test_dist.py:249-253);
- the dictionary top-2: distances rtol 1e-5 and word ids equal where the
  two best are apart by more than f32 noise; on integer descriptors
  (exact in f32) everything bit for bit, ties included;
- the copied numpy parts bit for bit on a grid of shapes.

One module fixture runs `python -m tpuslam_torch.tools.dist_worker` as
two gloo ranks and as one process, and `cli/slam_multihost.py` as two
gloo ranks, all at once on a written 6-frame 320x240 sequence; the tests
below read their outputs.  The RANSAC-driven parts (vo_from_features,
the partitioned Mapper against tpuslam's) are held in
test_torch_slam_batch.py, whose fixture has compiled tpuslam's
registration already.
"""

import json
import os
import subprocess
import sys
import threading

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.config import StereoBMConfig as JBMConfig
from tpuslam.dist import mesh as JM
from tpuslam.dist import multihost as JMH
from tpuslam.kernels import stereo_bm as JBM
from tpuslam.optim import device as jdev
from tpuslam_torch.config import SlamConfig, StereoBMConfig
from tpuslam_torch.dist import mesh as TM
from tpuslam_torch.dist import multihost as TMH
from tpuslam_torch.kernels import _cuda
from tpuslam_torch.optim import device as tdev

from test_dist import _ba_problem
from test_optim import make_noisy_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4            # shards of each mesh
PG_TOL = dict(chi2_rtol=2e-3, t_atol=2e-2)


@pytest.fixture(scope="module")
def jmesh():
    return JM.make_mesh(N)


@pytest.fixture(scope="module")
def tmesh():
    return TM.make_mesh(N, device="cpu")


def test_make_mesh():
    m = TM.make_mesh(N, axis="edges", device="cpu")
    assert m.devices == (torch.device("cpu"),) * N
    assert m.axis == "edges" and m.group is None
    assert (m.world, m.rank, m.local_size, m.size) == (1, 0, N, N)
    assert list(m.shard_ids()) == list(range(N))
    assert TM.make_mesh(device="cpu").size == 1


def test_initialize_and_backend_choice():
    """One process needs no process group; ranks on the CPU, or more
    ranks on a host than it has cards, take gloo (NCCL takes one card per
    rank)."""
    assert TMH.initialize("localhost:1", 1, 0) is None
    assert TMH.initialize(None, None, None) is None
    assert TMH.process_count() == 1 and TMH.process_index() == 0
    assert TMH.choose_backend(2, "cpu") == "gloo"
    assert TMH.choose_backend(torch.cuda.device_count() + 1) == "gloo"


@pytest.mark.parametrize("hosts, cards, backends, local", [
    # one rank per host, a card each: NCCL although the world is 4
    (["a", "b", "c", "d"], 1, ["nccl"] * 4, [0, 0, 0, 0]),
    # two ranks on each of two one-card hosts: they share a card
    (["a", "a", "b", "b"], 1, ["gloo"] * 4, [0, 1, 0, 1]),
    # three ranks on a two-card host: gloo, spread over both cards
    (["a", "a", "a"], 2, ["gloo"] * 3, [0, 1, 2]),
    (["a", "b", "a", "b"], 2, ["nccl"] * 4, [0, 0, 1, 1]),
])
def test_backend_choice_counts_ranks_per_host(monkeypatch, hosts, cards,
                                              backends, local):
    """The backend follows the ranks on each host, not the world size;
    each rank's index on its host picks its card (mod the host's cards)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    layout = [TMH.host_layout(hosts, r) for r in range(len(hosts))]
    assert [TMH.choose_backend(n) for n, _ in layout] == backends
    assert [i for _, i in layout] == local
    assert TMH.choose_backend(1, "cpu") == "gloo"


# ------------------------------------------------------------- front end

def _speckle_reference(raw, cfg):
    """(cv2.filterSpeckles of tpuslam's unspeckled map, tpuslam's
    speckled map, whether its 16 rounds converged)."""
    filtered = (cfg.min_disparity - 1) * 16
    ref, conv = JBM.speckle_filter_with_flag(
        jnp.asarray(raw, jnp.int32), cfg.speckle_window_size,
        cfg.speckle_range, filtered)
    out = raw.copy()
    cv2.filterSpeckles(out, filtered, cfg.speckle_window_size,
                       cfg.speckle_range)
    return out, np.asarray(ref).astype(np.int16), bool(conv)


@pytest.fixture(scope="module")
def frontend_pairs(jmesh):
    """8 random 64x256 pairs and tpuslam's sharded front end over them,
    speckle off and on."""
    rng = np.random.default_rng(5)
    lefts = rng.integers(0, 256, (2 * N, 64, 256), dtype=np.uint8)
    rights = np.ascontiguousarray(np.roll(lefts, 5, axis=2))
    cfg = JBMConfig(num_disparities=16, block_size=9)
    ref = {s: jax.device_get(JM.sharded_frontend_step(
        jmesh, cfg, with_speckle=s)(jnp.asarray(lefts), jnp.asarray(rights)))
        for s in (False, True)}
    return lefts, rights, cfg, ref


@pytest.mark.parametrize("speckle", [False, True])
def test_sharded_frontend_matches_reference(tmesh, frontend_pairs,
                                            speckle):
    """One batched plain StereoBM, LR check, response and blur per shard,
    nothing launched; outputs in frame order as tpuslam's."""
    lefts, rights, jcfg, ref = frontend_pairs
    cfg = StereoBMConfig(num_disparities=16, block_size=9)
    _cuda.reset_counters()
    disp, eig, blur = (o.numpy() for o in TM.sharded_frontend_step(
        tmesh, cfg, with_speckle=speckle)(lefts, rights))
    for k in ("stereo_bm", "lr_check", "gftt", "orb_blur"):
        assert _cuda.PLAIN_CALLS[k] == N, k
    assert sum(_cuda.LAUNCHES.values()) == 0
    jd, je, jb = ref[speckle]
    assert disp.shape == jd.shape and disp.dtype == jd.dtype
    if speckle:
        for i in range(len(lefts)):
            want, jref, conv = _speckle_reference(ref[False][0][i], jcfg)
            np.testing.assert_array_equal(disp[i], want)
            if conv:
                np.testing.assert_array_equal(disp[i], jref)
    else:
        np.testing.assert_array_equal(disp, jd)
    np.testing.assert_allclose(eig, je, rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(blur, jb)


def test_sharded_frontend_equals_frontend_one(tmesh, frontend_pairs):
    """Each frame's outputs equal frontend_one on that frame bit for bit
    (a shard's batch does not change a frame)."""
    lefts, rights, _, _ = frontend_pairs
    cfg = StereoBMConfig(num_disparities=16, block_size=9)
    outs = TM.sharded_frontend_step(tmesh, cfg)(lefts, rights)
    for i in (0, 3, 7):
        one = TM.frontend_one(lefts[i], rights[i], cfg, device="cpu")
        for a, b in zip(outs, one):
            assert torch.equal(a[i], b)


def test_sharded_frontend_refuses_uneven_batch(tmesh, frontend_pairs):
    lefts, rights, _, _ = frontend_pairs
    with pytest.raises(ValueError, match="divisible"):
        TM.sharded_frontend_step(tmesh)(lefts[:6], rights[:6])


# ------------------------------------------------------------ pose graph

def _graph(n, forward_lc=False, seed=9):
    from tpuslam.mapping.graph import Link, LOOP_CLOSURE
    _, poses, links = make_noisy_loop(np.random.default_rng(seed), n=n)
    if forward_lc:
        fwd = np.eye(4, dtype=np.float32)
        fwd[:3, 3] = [0.5, 0.1, -0.2]
        links.insert(10, Link(10, n - 30, LOOP_CLOSURE, fwd,
                              np.eye(6) * 2.0))
    return jdev.graph_to_arrays(poses, links)[1:]


def _hold_pg(got, ref):
    (gp, gc), (rp, rc) = got, ref
    np.testing.assert_allclose(np.asarray(gc), np.asarray(rc),
                               rtol=PG_TOL["chi2_rtol"])
    np.testing.assert_allclose(np.asarray(gp)[:, :3, 3],
                               np.asarray(rp)[:, :3, 3], rtol=0,
                               atol=PG_TOL["t_atol"])


def test_sharded_pose_graph_matches_reference(jmesh, tmesh):
    """Edge-sharded dense LM: the port's against tpuslam's on the same
    padded edges, and against the port's unsharded lm_solve."""
    pose_arr, e_from, e_to, Z, Omega, free_idx = _graph(81)
    V, iters = len(pose_arr), 5
    ef, et, Zp, Op = TM.pad_edges(e_from, e_to, Z, Omega, N)
    assert len(ef) > len(e_from)          # the padding is exercised
    ref = JM.sharded_pose_graph_step(jmesh, V, V - 1, iterations=iters)(
        *(jnp.asarray(a) for a in (pose_arr, ef, et, Zp, Op, free_idx)))
    got = TM.sharded_pose_graph_step(tmesh, V, V - 1, iterations=iters)(
        pose_arr, ef, et, Zp, Op, free_idx)
    _hold_pg(got, ref)
    one = tdev.lm_solve(*(torch.as_tensor(a) for a in (
        pose_arr, e_from, e_to, Z, Omega, free_idx)), V - 1,
        iterations=iters)
    _hold_pg(got, one)
    assert got[1][-1] < got[1][0]


def test_sharded_sparse_step_matches_reference(jmesh, tmesh):
    """The sparse step with a forward loop closure (a Woodbury extra):
    the port's against tpuslam's and the port's unsharded dense LM; the
    root solve runs once per iteration (the plain block-Thomas here)."""
    pose_arr, e_from, e_to, Z, Omega, free_idx = _graph(100, True)
    V, iters = len(pose_arr), 5
    xsel, xp, xq = tdev.classify_extra_edges(e_from, e_to, free_idx)
    assert len(xp) >= 1
    ef, et, Zp, Op = TM.pad_edges(e_from, e_to, Z, Omega, N)
    xsel_p = np.full(len(ef), -1, np.int32)
    xsel_p[:len(xsel)] = xsel
    ref = JM.sharded_pose_graph_step_sparse(jmesh, V - 1,
                                            iterations=iters)(
        *(jnp.asarray(a) for a in (pose_arr, ef, et, Zp, Op, free_idx,
                                   xsel_p, xp, xq)))
    _cuda.reset_counters()
    got = TM.sharded_pose_graph_step_sparse(tmesh, V - 1,
                                            iterations=iters)(
        pose_arr, ef, et, Zp, Op, free_idx, xsel_p, xp, xq)
    assert _cuda.PLAIN_CALLS["thomas"] == iters
    assert _cuda.LAUNCHES["thomas"] == 0
    _hold_pg(got, ref)
    dense = tdev.lm_solve(*(torch.as_tensor(a) for a in (
        pose_arr, e_from, e_to, Z, Omega, free_idx)), V - 1,
        iterations=iters)
    _hold_pg(got, dense)


def test_suite_closure_diverges_in_both():
    """The JAX suite's arbitrary forward closure (0.5 m off the loop,
    Omega = 2 I) at 200 vertices: tpuslam's dense LM diverges (chi2 rises
    over 5 iterations) and so does the port's, its first step within
    chi2 rtol 2e-3 of tpuslam's; the card's phase takes an exact closure
    on this graph for that reason."""
    pose_arr, e_from, e_to, Z, Omega, free_idx = _graph(200, True)
    V, iters = len(pose_arr), 5
    ref = jdev.lm_solve(*(jnp.asarray(a) for a in (
        pose_arr, e_from, e_to, Z, Omega, free_idx)), V - 1,
        iterations=iters)[1]
    got = tdev.lm_solve(*(torch.as_tensor(a) for a in (
        pose_arr, e_from, e_to, Z, Omega, free_idx)), V - 1,
        iterations=iters)[1]
    ref, got = np.asarray(ref), got.numpy()
    assert ref[-1] > 2 * ref[0] and got[-1] > 2 * got[0]
    np.testing.assert_allclose(got[:2], ref[:2], rtol=PG_TOL["chi2_rtol"])


# -------------------------------------------------------------------- BA

def test_sharded_ba_matches_reference(jmesh, tmesh):
    intr, Tcw0, lms0, obs_cam, obs_lm, uv, obs_valid = _ba_problem(
        W=6, L=96, O=768, seed=2)
    W, iters = Tcw0.shape[0], 5
    lms_p, oc, ol, uvp, ov, L_local, _ = TM.shard_ba_problem(
        lms0, obs_cam, obs_lm, uv, obs_valid, N)
    args = (Tcw0, lms_p, intr, oc, ol, uvp, ov)
    jT, jl, jc = JM.make_sharded_ba_step(
        jmesh, W, L_local, iterations=iters, huber_delta=4.0)(
        *(jnp.asarray(a) for a in args))
    tT, tl, tc = TM.make_sharded_ba_step(
        tmesh, W, L_local, iterations=iters, huber_delta=4.0)(*args)
    cost0 = TM.make_sharded_ba_step(tmesh, W, L_local, iterations=0,
                                    huber_delta=4.0)(*args)[2]
    assert float(tc) < 0.2 * float(cost0)
    np.testing.assert_allclose(float(tc), float(jc), rtol=5e-2)
    np.testing.assert_allclose(tT.numpy()[:, :3, 3],
                               np.asarray(jT)[:, :3, 3], rtol=0, atol=5e-3)
    assert tl.shape == lms_p.shape


# ------------------------------------------------------ dictionary top-2

@pytest.mark.parametrize("kind", ["float", "integer"])
def test_sharded_dict_top2_matches_reference(kind):
    rng = np.random.default_rng(11)
    Q, W = 48, 200
    if kind == "integer":      # descriptor bytes: exact in f32, with ties
        train = rng.integers(0, 256, (W, 32)).astype(np.float32)
        train[100:120] = train[:20]
        query = train[rng.choice(W, Q)] + \
            rng.integers(0, 2, (Q, 32)).astype(np.float32)
    else:
        train = rng.standard_normal((W, 32)).astype(np.float32)
        query = rng.standard_normal((Q, 32)).astype(np.float32)
    wids = rng.permutation(10 * W)[:W].astype(np.int32)
    valid = rng.random(W) > 0.1
    jm = JM.make_mesh(N, axis="words")
    jd1, jw1, jd2 = (np.asarray(a) for a in JM.sharded_dict_top2_step(jm)(
        *(jnp.asarray(a) for a in (query, train, wids, valid))))
    tm = TM.make_mesh(N, axis="words", device="cpu")
    d1, w1, d2 = (a.numpy() for a in TM.sharded_dict_top2_step(tm)(
        query, train, wids, valid))
    with pytest.raises(ValueError, match="axis"):
        TM.sharded_dict_top2_step(TM.make_mesh(N, device="cpu"))
    if kind == "integer":
        for a, b in ((d1, jd1), (w1, jw1), (d2, jd2)):
            np.testing.assert_array_equal(a, b)
        return
    np.testing.assert_allclose(d1, jd1, rtol=1e-5)
    np.testing.assert_allclose(d2, jd2, rtol=1e-5)
    apart = (jd2 - jd1) > 1e-4 * jd2
    assert apart.mean() > 0.9
    np.testing.assert_array_equal(w1[apart], jw1[apart])


# ------------------------------------------------------ copied numpy parts

def test_pad_edges_and_frame_block_equal_reference():
    rng = np.random.default_rng(1)
    for E in range(1, 10):
        for multiple in (1, 2, 4, 8):
            arrays = (rng.integers(0, 9, E).astype(np.int32),
                      rng.integers(0, 9, E).astype(np.int32),
                      rng.standard_normal((E, 4, 4)).astype(np.float32),
                      rng.standard_normal((E, 6, 6)).astype(np.float32))
            for a, b in zip(TM.pad_edges(*arrays, multiple),
                            JM.pad_edges(*arrays, multiple)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    for n in range(0, 22):
        for p in range(1, 6):
            for i in range(p):
                assert TMH.frame_block(n, p, i) == JMH.frame_block(n, p, i)


@pytest.mark.parametrize("L, shards", [(5, 1), (16, 2), (33, 4), (40, 8)])
def test_shard_ba_problem_equals_reference(L, shards):
    rng = np.random.default_rng(L)
    O = 3 * L
    lms = rng.standard_normal((L, 3)).astype(np.float32)
    args = (lms, rng.integers(0, 4, O).astype(np.int32),
            rng.integers(0, L, O).astype(np.int32),
            rng.standard_normal((O, 2)).astype(np.float32),
            rng.random(O) > 0.2, shards)
    for a, b in zip(TM.shard_ba_problem(*args), JM.shard_ba_problem(*args)):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------- sharded dictionary, P = 2

class ThreadComm:
    """Barrier-based all-gather across P threads in one process
    (tests/test_partitioned_map.py's)."""

    def __init__(self, world: int):
        self.world = world
        self.slots = [None] * world
        self.barrier = threading.Barrier(world)
        self.lock = threading.Lock()

    def make(self, rank: int):
        def allgather(arr):
            with self.lock:
                self.slots[rank] = np.asarray(arr)
            self.barrier.wait(timeout=300)
            out = np.stack(self.slots)
            self.barrier.wait(timeout=300)   # all read before any write
            return out
        return allgather


def in_lockstep(world, work):
    """work(rank) on `world` threads at once; their results in rank
    order (an error on any thread fails the test)."""
    out, errors = [None] * world, [None] * world

    def run(rank):
        try:
            out[rank] = work(rank)
        except BaseException as e:      # reported below, in the caller
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    for e in errors:
        if e is not None:
            raise e
    return out


def _batches(rng, n_nodes=5, n=96):
    """Descriptor batches with exact repeats and one-byte variants of
    earlier rows, so both the new-word and the add-reference branches
    run."""
    seen, out = [], []
    for _ in range(n_nodes):
        d = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        if seen:
            old = np.concatenate(seen)
            d[: n // 2] = old[rng.choice(len(old), n // 2, replace=False)]
            d[: n // 4, 0] ^= np.uint8(1)
        seen.append(d)
        out.append(d)
    return out


def test_sharded_dictionary_matches_single_and_reference():
    """Two ranks of the port's ShardedVWDictionary (thread lock-step):
    the single-process dictionary's word ids, its rows split by word id
    % 2 with their references; and tpuslam's ShardedVWDictionary carried
    across mid-run (convert.sharded_dictionary_from_reference) makes the
    next decisions as tpuslam's does."""
    from tpuslam.dist.partitioned_map import ShardedVWDictionary as JSD
    from tpuslam_torch import convert
    from tpuslam_torch.dist.partitioned_map import ShardedVWDictionary
    from tpuslam_torch.mapping.dictionary import VWDictionary
    batches = _batches(np.random.default_rng(3))
    single = VWDictionary(0.8, device="cpu")
    want = [single.add_new_words(d, i + 1) for i, d in enumerate(batches)]
    comm = ThreadComm(2)

    def port(rank):
        vwd = ShardedVWDictionary(0.8, rank, 2, comm.make(rank), "cpu")
        return vwd, [vwd.add_new_words(d, i + 1)
                     for i, d in enumerate(batches)]

    (v0, ids0), (v1, ids1) = in_lockstep(2, port)
    assert ids0 == ids1 == want
    assert len(v0) == len(v1) == len(single)
    assert set(v0.words) | set(v1.words) == set(single.words)
    assert all(w % 2 == 0 for w in v0.words)
    assert all(w % 2 == 1 for w in v1.words)
    for wid, vw in single.words.items():
        assert (v0 if wid % 2 == 0 else v1).words[wid].references == \
            vw.references
    assert v0.owned_bytes() + v1.owned_bytes() == len(single) * 128

    # tpuslam's two ranks up to the mid-run state, then both packages on
    jcomm, tcomm = ThreadComm(2), ThreadComm(2)
    nxt = batches[-1].copy()
    nxt[::3, 5] ^= np.uint8(3)

    def mid_run(rank):
        j = JSD(0.8, rank, 2, comm=jcomm.make(rank))
        for i, d in enumerate(batches[:-1]):
            j.add_new_words(d, i + 1)
        t = convert.sharded_dictionary_from_reference(
            j, device="cpu", comm=tcomm.make(rank))
        return (j.add_new_words(nxt, 9), t.add_new_words(nxt, 9), j, t)

    for jids, tids, j, t in in_lockstep(2, mid_run):
        assert tids == jids
        assert t._count == j._count and len(t) == len(j)
        np.testing.assert_array_equal(t._train[:t._count],
                                      j._train[:j._count])
        assert {k: w.references for k, w in t.words.items()} == \
            {k: w.references for k, w in j.words.items()}


def test_partitioned_mapper_refuses_async_loop_closure():
    from tpuslam_torch.dist.partitioned_map import PartitionedMapper
    from tpuslam_torch.io.synthetic import sequence_camera
    pm = PartitionedMapper(sequence_camera(320, 240, 260.0, 0.54), rank=0,
                           world=1, device="cpu")
    assert pm.async_lc is False and pm.device_dict_ok is False
    with pytest.raises(ValueError, match="async_lc"):
        pm.async_lc = True


# ------------------------------------------------ the multi-process path

@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    from tpuslam_torch.io.synthetic import write_sequence
    return write_sequence(str(tmp_path_factory.mktemp("distseq")),
                          n_frames=6, width=320, height=240, f=260.0,
                          baseline=0.54, speed=0.3, seed=9, device="cpu")


def test_extract_block_features_matches_reference(seq):
    """The port's batched front end over a frame block against tpuslam's
    (keypoints exact, their responses to rtol 2e-6, descriptors, 3D
    points and counts bit for bit), and independent of the batch: the
    same block in batches of 2 and of 3 frames."""
    from tpuslam.geometry.camera import StereoCameraModel as JCam
    from tpuslam.config import SlamConfig as JSlamConfig
    from tpuslam_torch.geometry.camera import StereoCameraModel
    from tpuslam_torch.io.dataset import StereoImageDataset
    from tpuslam_torch.vo.fused import FusedShapes
    ds = StereoImageDataset(left_dir=os.path.join(seq, "image_0"),
                            right_dir=os.path.join(seq, "image_1"))
    items = [ds[i] for i in range(3)]
    lefts = np.stack([it["left"] for it in items])
    rights = np.stack([it["right"] for it in items])
    cam = StereoCameraModel.load_kitti(os.path.join(seq, "calib.txt"),
                                       image_size=(320, 240))
    got = TMH.extract_block_features(lefts, rights, cam, SlamConfig(),
                                     FusedShapes(chunk=2), device="cpu")
    by3 = TMH.extract_block_features(lefts, rights, cam, SlamConfig(),
                                     FusedShapes(chunk=3), device="cpu")
    ref = JMH.extract_block_features(
        lefts, rights, JCam(P_l=cam.P_l, P_r=cam.P_r, width=320,
                            height=240), JSlamConfig())
    assert sorted(got) == sorted(ref)
    for k in got:
        np.testing.assert_array_equal(got[k], by3[k])
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
    for k in ("desc", "pts3d", "n_kpts"):
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(got["kpts"][..., :2], ref["kpts"][..., :2])
    np.testing.assert_allclose(got["kpts"][..., 2], ref["kpts"][..., 2],
                               rtol=2e-6, atol=1e-7)
    assert got["n_kpts"].min() > 100


@pytest.fixture(scope="module")
def dist_runs(seq, tmp_path_factory, free_port):
    """The worker as two gloo ranks and as one process, and the CLI as two
    gloo ranks, at once on the CPU; (worker outputs, CLI output dir)."""
    out = str(tmp_path_factory.mktemp("distout"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    worker = [sys.executable, "-m", "tpuslam_torch.tools.dist_worker",
              seq]
    opts = ["--device", "cpu", "--backend", "gloo", "--chunk", "4"]
    wcoord, ccoord = f"localhost:{free_port()}", f"localhost:{free_port()}"
    cmds = [worker + [os.path.join(out, "two"), wcoord, "2", str(r)] + opts
            for r in range(2)]
    cmds.append(worker + [os.path.join(out, "one"), "-", "1", "0"] + opts)
    cmds += [[sys.executable, "-m", "tpuslam_torch.cli.slam_multihost", seq,
              "-coord", ccoord, "-num-procs", "2", "-rank", str(r), "-out",
              os.path.join(out, "cli"), "-quiet", "-device", "cpu"]
             for r in range(2)]
    procs = [subprocess.Popen(c, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    logs = [p.communicate(timeout=600)[0].decode(errors="replace")
            for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        assert p.returncode == 0, f"{c}:\n{log[-3000:]}"
    runs = {k: np.load(os.path.join(out, k, "rank0.npz"))
            for k in ("two", "one")}
    runs["two1"] = np.load(os.path.join(out, "two", "rank1.npz"))
    return runs, os.path.join(out, "cli")


def test_ranks_agree_and_equal_one_process(dist_runs):
    """Both ranks' VO and optimised poses are equal; the VO poses equal
    the one-process run's bit for bit; the global mesh spans 2 x 2
    shards."""
    runs, _ = dist_runs
    r0, r1, one = runs["two"], runs["two1"], runs["one"]
    assert int(r0["n_devices"]) == 4 and int(one["n_devices"]) == 2
    assert str(r0["backend"]) == "gloo" and str(one["backend"]) == "None"
    for k in ("poses", "opt_poses", "chis", "sp_opt_poses", "sp_chis"):
        np.testing.assert_array_equal(r0[k], r1[k])
    np.testing.assert_array_equal(r0["poses"], one["poses"])
    assert np.linalg.norm(r0["poses"][-1][:3, 3]) > 1.0


def test_global_mesh_pose_graph(dist_runs):
    """The dense and sparse steps on the 4-shard global mesh make
    progress and agree with the 2-shard one-process run, and the
    dictionary top-2 on it equals one unsharded search.  The collectives:
    per iteration the dense step's two all-reduces of the system and one
    of chi2, the sparse step's the same plus the root solve's broadcast;
    the top-2's two all-gathers; none in the one-process run."""
    runs, _ = dist_runs
    r0, one = runs["two"], runs["one"]
    for p, c in (("opt_poses", "chis"), ("sp_opt_poses", "sp_chis")):
        assert np.isfinite(r0[p]).all() and r0[c][-1] < r0[c][0]
        _hold_pg((r0[p], r0[c]), (one[p], one[c]))
    coll = json.loads(str(r0["collectives"]))
    assert coll["pose_graph"] == dict(all_reduce=2 * 3 * 5, broadcast=5,
                                      all_gather=0, host_hop=0)
    assert coll["dict_top2"] == dict(all_reduce=0, broadcast=0,
                                     all_gather=2, host_hop=0)
    for r in (r0, runs["two1"], one):
        assert bool(r["top2_equal"])
    np.testing.assert_array_equal(r0["top2_w1"], runs["two1"]["top2_w1"])
    assert sum(json.loads(str(one["collectives"]))["pose_graph"].values()) \
        == 0


def test_partitioned_map_across_processes(dist_runs):
    """Both ranks agree on the global dictionary, own disjoint
    complementary shards (even / odd word ids) and hold part of the
    keyframe features; the partitioned mapper's words, links and link
    transforms equal the single-process Mapper's bit for bit, its
    likelihoods to rtol 1e-12; and the one-process run's equal the
    two-process run's."""
    runs, _ = dist_runs
    r0, r1, one = runs["two"], runs["two1"], runs["one"]
    assert int(r0["total_words"]) == int(r1["total_words"]) > 0
    w0, w1 = set(r0["owned_words"].tolist()), set(r1["owned_words"].tolist())
    assert not w0 & w1 and len(w0) + len(w1) == int(r0["total_words"])
    assert all(w % 2 == 0 for w in w0) and all(w % 2 == 1 for w in w1)
    assert int(r0["owned_feat_bytes"]) > 0 and int(r1["owned_feat_bytes"]) > 0
    assert int(r0["owned_feat_bytes"]) + int(r1["owned_feat_bytes"]) == \
        int(one["owned_feat_bytes"])
    for k in ("pm_lik", "pm_words", "pm_links", "pm_link_tfs"):
        np.testing.assert_array_equal(r0[k], r1[k])
    for k in ("words", "links", "link_tfs", "lik_ids", "lik_cands"):
        np.testing.assert_array_equal(r0["pm_" + k], r0["sm_" + k])
        np.testing.assert_array_equal(r0["pm_" + k], one["pm_" + k])
    assert int(r0["n_lc_pm"]) == int(r0["n_lc_sm"])
    assert r0["pm_lik"].size > 0 and np.any(r0["pm_lik"] != 0.0)
    np.testing.assert_allclose(r0["pm_lik"], r0["sm_lik"], rtol=1e-12,
                               atol=1e-14)
    m0, m1 = (json.loads(str(r["map_bytes"])) for r in (r0, r1))
    assert m0["Mapper.words"] > 0 and m1["Mapper.words"] > 0


def test_cli_two_processes(dist_runs):
    _, out = dist_runs
    p0 = np.loadtxt(os.path.join(out, "poses_rank0.txt"))
    p1 = np.loadtxt(os.path.join(out, "poses_rank1.txt"))
    np.testing.assert_array_equal(p0, p1)
    assert p0.shape == (6, 12)
    assert np.linalg.norm(p0[-1].reshape(3, 4)[:, 3]) > 0.5
    res = []
    for r in range(2):
        with open(os.path.join(out, f"result_rank{r}.json")) as f:
            res.append(json.load(f))
    assert res[0]["n_frames"] == res[1]["n_frames"] == 6
    assert res[0]["backend"] == res[1]["backend"] == "gloo"
    assert res[0]["map_bytes"]["Mapper.words"] > 0
    assert res[1]["map_bytes"]["Mapper.words"] > 0
