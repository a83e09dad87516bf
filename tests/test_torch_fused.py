"""tpuslam_torch fused VO and chunk driver against tpuslam's.

FastSlamPipeline on test_fast_pipeline.py's 320x240 12-frame synthetic
sequence (chunk 6, capacity 384), in the default configuration
(SlamConfig(): left-right check and one LM refine round) and in the first
slice's configuration (neither), with tpuslam's own RANSAC draws injected
into the port.  Both read the same decoded frames.
Tolerances: the lost and keyframe flags must be equal; inlier counts may
differ by 2 and per-frame translations by 1e-3 m — registration noise
from f32 reduction order and the XLA CPU backend's FMA contraction in the
GFTT response (see test_torch_gftt.py), which can move a keypoint near a
response tie (tpuslam/vo/fused.py:29-32 holds its own trajectories to the
same kind of noise).  The covariance medians are bit-equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tpuslam.config import DepthMethod, MapperConfig, PnPConfig, \
    SGBMConfig, SlamConfig, StereoBMConfig
from tpuslam.vo import fused as JF
from tpuslam_torch import convert
from tpuslam_torch.vo import fused as TF


def _jax_draws(frame):
    return np.array(jax.random.uniform(jax.random.PRNGKey(frame), (300, 6)))


def _small_map(cfg):
    return dataclasses.replace(
        cfg, mapper=MapperConfig(map_update=2, max_stm_size=5))


def _slice_cfg():
    return _small_map(SlamConfig().replace(
        bm=StereoBMConfig(disp12_max_diff=-1),
        pnp=PnPConfig(refine_iterations=0)))


def _default_cfg():
    return _small_map(SlamConfig())


@pytest.fixture(scope="module")
def fwd_seq(tmp_path_factory):
    from tpuslam.io.synthetic import make_sequence
    from tpuslam.io.dataset import StereoImageDataset
    out = str(tmp_path_factory.mktemp("torch_fastseq"))
    make_sequence(out, n_frames=12, width=320, height=240, f=250.0,
                  baseline=0.54, speed=0.4, yaw_rate=0.002, seed=3)
    ds = StereoImageDataset(
        left_dir=os.path.join(out, "image_0"),
        right_dir=os.path.join(out, "image_1"),
        times_path=os.path.join(out, "times.txt"),
        gt_path=os.path.join(out, "poses.txt"))
    return [ds[i] for i in range(len(ds))]


def _camera(items):
    from tpuslam.geometry.camera import StereoCameraModel
    h, w = items[0]["left"].shape
    f, cx, cy, B = 250.0, (w - 1) / 2.0, (h - 1) / 2.0, 0.54
    P0 = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]], np.float64)
    P1 = P0.copy()
    P1[0, 3] = -f * B
    return StereoCameraModel(P_l=P0, P_r=P1, width=w, height=h)


def _port_pipe(items, cfg=None, chunk=6, **kw):
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    return FastSlamPipeline(convert.camera_from_reference(_camera(items)),
                            convert.config_from_reference(
                                cfg or _slice_cfg()),
                            chunk=chunk, capacity=384, draws_fn=_jax_draws,
                            device="cpu", **kw)


@pytest.fixture(scope="module")
def reference_run(fwd_seq):
    """tpuslam on the slice configuration: all 12 frames, plus its carry
    after chunk 1 (as numpy)."""
    from tpuslam.runtime.fast_pipeline import FastSlamPipeline
    pipe = FastSlamPipeline(_camera(fwd_seq), _slice_cfg(), chunk=6,
                            capacity=384)
    first = pipe.run(fwd_seq[:6])
    carry1 = jax.tree_util.tree_map(np.asarray, jax.device_get(pipe.carry))
    second = pipe.run(fwd_seq[6:])
    return first + second, carry1


@pytest.fixture(scope="module")
def port_run(fwd_seq):
    return _port_pipe(fwd_seq).run(fwd_seq)


def _assert_close_runs(got, ref):
    assert len(got) == len(ref)
    assert [i.lost for i in got] == [i.lost for i in ref]
    assert [i.keyframe_added for i in got] == [i.keyframe_added for i in ref]
    for a, b in zip(got, ref):
        assert abs(a.num_inliers - b.num_inliers) <= 2, \
            (a.num_inliers, b.num_inliers)
        np.testing.assert_allclose(a.transform[:3, 3], b.transform[:3, 3],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(a.pose[:3, 3], b.pose[:3, 3],
                                   rtol=0, atol=1e-3)


def test_slice_matches_reference(port_run, reference_run, fwd_seq):
    ref, _ = reference_run
    _assert_close_runs(port_run, ref)
    assert not any(i.lost for i in port_run[1:])
    assert min(i.num_inliers for i in port_run[1:]) >= 50
    # and it tracks ground truth like tpuslam does on this sequence
    err = np.linalg.norm(port_run[-1].pose[:3, 3] -
                         fwd_seq[-1]["ground_truth"][:3, 3])
    assert err < 0.10, err


def test_chunk2_from_reference_carry(reference_run, fwd_seq):
    """Start the port from tpuslam's carry after chunk 1
    (convert.carry_from_reference): chunk 2 agrees."""
    ref, carry1 = reference_run
    pipe = _port_pipe(fwd_seq)
    pipe.carry = convert.carry_from_reference(carry1, "cpu")
    pipe._frames = 6
    pipe._prev_stamp = float(fwd_seq[5]["stamp"])
    got = pipe.run(fwd_seq[6:])
    _assert_close_runs(got, ref[6:])


def test_staged_sync_and_async_identical(fwd_seq, port_run):
    """run_staged, synchronous and with the consumer thread, over the
    first chunk: identical to run()."""
    items = fwd_seq[:6]
    pipe = _port_pipe(items)
    staged = pipe.stage_chunks(items)
    a = pipe.run_staged(staged, items)
    pipe.reset()
    b = pipe.run_staged(staged, items, mapper_async=True)
    assert len(a) == len(b) == 6
    for x, y, z in zip(a, b, port_run):
        np.testing.assert_array_equal(x.pose, y.pose)
        np.testing.assert_array_equal(x.pose, z.pose)
        assert x.num_inliers == y.num_inliers == z.num_inliers


@pytest.mark.parametrize("case", ["speckle"])
def test_unported_paths_raise(fwd_seq, case):
    """Fused speckle, refused until it was ported for StereoBM, builds a
    pipeline that runs a chunk on the CPU through the batch speckle
    filter."""
    from tpuslam_torch.kernels import stereo_bm as BM
    pipe = _port_pipe(fwd_seq, _default_cfg().replace(fused_speckle=True))
    BM.SPECKLE_ROUNDS.clear()
    infos = pipe.run(fwd_seq[:6])
    assert len(infos) == 6 and len(BM.SPECKLE_ROUNDS) == 1
    assert not any(i.lost for i in infos[1:])


def _sgbm_cfg(**kw):
    """SGBM at tests/test_sgbm.py's small range (min_d 0, 64 disparities)
    in the default configuration."""
    return _default_cfg().replace(
        depth_method=DepthMethod.SGBM,
        sgbm=SGBMConfig(min_disparity=0, num_disparities=64), **kw)


def test_sgbm_chunk_matches_reference(fwd_seq):
    """A 4-frame fused chunk with SGBM on the CPU against tpuslam's: flags
    equal, inliers within 2, translations within 1e-3 m (the disparity is
    bit-equal, test_torch_sgbm.py); the speckled chunk runs the batch
    filter once."""
    from tpuslam.runtime.fast_pipeline import FastSlamPipeline
    from tpuslam_torch.kernels import stereo_bm as BM
    items = fwd_seq[:4]
    ref = FastSlamPipeline(_camera(items), _sgbm_cfg(), chunk=4,
                           capacity=384).run(items)
    got = _port_pipe(items, _sgbm_cfg(), chunk=4).run(items)
    _assert_close_runs(got, ref)
    assert not any(i.lost for i in got[1:])
    BM.SPECKLE_ROUNDS.clear()
    speckled = _port_pipe(items, _sgbm_cfg(fused_speckle=True),
                          chunk=4).run(items)
    assert len(speckled) == 4 and len(BM.SPECKLE_ROUNDS) == 1
    assert not any(i.lost for i in speckled[1:])


@pytest.fixture(scope="module")
def bm_chunk(fwd_seq):
    items = fwd_seq[:4]
    return _port_pipe(items, _default_cfg(), chunk=4).run(items)


@pytest.mark.parametrize("method", ["lk", "cv_bm"])
def test_sparse_and_oracle_methods_run_bm_fused(fwd_seq, bm_chunk, method):
    """The fused program has only the dense engines: with "lk" or "cv_bm"
    it runs StereoBM, as tpuslam's does (tpuslam/vo/fused.py:242-252), so
    the chunk equals the "bm" chunk."""
    items = fwd_seq[:4]
    bm = bm_chunk
    got = _port_pipe(items, _default_cfg().replace(
        depth_method=DepthMethod(method)), chunk=4).run(items)
    for a, b in zip(got, bm):
        np.testing.assert_array_equal(a.pose, b.pose)
        assert a.num_inliers == b.num_inliers


@pytest.fixture(scope="module")
def default_runs(fwd_seq):
    """tpuslam and the port in SlamConfig() over all 12 frames, and the
    port's plain-version counts."""
    from tpuslam.runtime.fast_pipeline import FastSlamPipeline
    from tpuslam_torch.kernels import _cuda
    ref = FastSlamPipeline(_camera(fwd_seq), _default_cfg(), chunk=6,
                           capacity=384).run(fwd_seq)
    _cuda.reset_counters()
    got = _port_pipe(fwd_seq, _default_cfg()).run(fwd_seq)
    return got, ref, dict(_cuda.PLAIN_CALLS)


def test_default_config_matches_reference(default_runs, fwd_seq):
    """The left-right check and the refine round on: flags equal,
    inliers within 2, translations within 1e-3 m of tpuslam's."""
    got, ref, _ = default_runs
    _assert_close_runs(got, ref)
    assert not any(i.lost for i in got[1:])
    err = np.linalg.norm(got[-1].pose[:3, 3] -
                         fwd_seq[-1]["ground_truth"][:3, 3])
    assert err < 0.10, err


def test_default_config_takes_every_plain_version(default_runs):
    """On the CPU the default run goes through the plain version of every
    kernel: StereoBM, the LR check, GFTT and ORB once per chunk, the
    medians and the LM refine once per frame (one refine round); the pose
    graph's block-Thomas solve (K7's) never."""
    plain = default_runs[2]
    assert plain == dict(stereo_bm=2, gftt=2, orb=2, median=12,
                         lr_check=2, lm_refine=12, stereo_bm_phase=0,
                         orb_blur=0, orb_tests=0, thomas=0)


MEDIAN_CASES = [(1536, 0.5, False), (1536, 0.0, False), (100, 0.9, False),
                (7, 1.0, False), (1536, 0.001, False), (1536, 1.0, True),
                (64, "one", False), (64, 0.7, "inf")]


def _median_inputs(n, frac, ties, rng):
    x = np.abs(rng.normal(0, 10, n)).astype(np.float32)
    if ties is True:
        x = np.round(x)
    if ties == "inf":
        x[::3] = np.inf
    y = np.abs(rng.normal(0, 2, n)).astype(np.float32)
    if frac == "one":
        m = np.zeros(n, bool)
        m[n // 2] = True
    else:
        m = rng.uniform(size=n) < frac
    return x, y, m


@pytest.mark.parametrize("case", range(len(MEDIAN_CASES)))
def test_masked_median_bit_equal(case):
    """Plain version of K4 vs tpuslam's sort median and its Pallas
    bisection kernel (interpreted on the CPU): equal, including count 0
    and 1, ties and +inf."""
    x, y, m = _median_inputs(*MEDIAN_CASES[case], np.random.default_rng(7))
    a0, c0 = JF._masked_median(jnp.asarray(x), jnp.asarray(m))
    b0, _ = JF._masked_median(jnp.asarray(y), jnp.asarray(m))
    a1, b1, c1 = JF._masked_median2_pallas(jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(m))
    ta, tb, tc = TF.masked_median2(torch.as_tensor(x)[None],
                                   torch.as_tensor(y)[None],
                                   torch.as_tensor(m)[None])
    assert float(ta[0]) == float(a0) == float(a1)
    assert float(tb[0]) == float(b0) == float(b1)
    assert int(tc[0]) == int(c0) == int(c1)


def test_transform_helpers_match(rng):
    for _ in range(4):
        v = rng.normal(0, 0.3, 6).astype(np.float32)
        a = np.asarray(JF._from_rpy_xyz(*[jnp.float32(x) for x in v]))
        ta = TF._from_rpy_xyz(*[torch.tensor(float(x)) for x in v])
        np.testing.assert_allclose(ta.numpy(), a, atol=1e-6)
        w = rng.normal(0, 0.3, 6).astype(np.float32)
        b = np.array(JF._from_rpy_xyz(*[jnp.float32(x) for x in w]))
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        np.testing.assert_allclose(TF._compose(ta, torch.as_tensor(b)),
                                   np.asarray(JF._compose(ja, jb)), atol=1e-6)
        np.testing.assert_allclose(TF._inv(ta), np.asarray(JF._inv(ja)),
                                   atol=1e-6)
        for got, ref in zip(TF._get_rpy(ta), JF._get_rpy(ja)):
            assert abs(float(got) - float(ref)) < 1e-6

