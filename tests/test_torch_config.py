"""The port's copied modules, its import isolation and its precision pin.

The GPU machine has no JAX, so the numpy-only modules the port needs are
copied into tpuslam_torch; these tests keep each copy equal to its
original: the code (docstrings aside) and the values it produces.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpuslam
import tpuslam_torch
from tpuslam_torch import convert


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["config.py", "geometry/transform.py", "geometry/camera.py",
          "geometry/kitti_metric.py", "vo/frame.py", "mapping/graph.py",
          "runtime/perf.py", "mapping3d/octree_bt.py", "runtime/logger.py",
          "io/patterns.py", "io/imu.py", "runtime/frame_meas.py",
          "calib/yaml_io.py"]
# numpy functions and classes copied into a module of the port that also
# holds torch code: (module path, name)
COPIED_DEFS = [("kernels/gftt.py", "select_from_candidates"),
               ("kernels/gftt.py", "select_keypoints"),
               ("kernels/gftt.py", "_grid_suppress"),
               ("kernels/orb.py", "run_by_image_border"),
               ("io/dataset.py", "list_images"),
               ("io/dataset.py", "import_poses"),
               ("io/dataset.py", "save_poses"),
               ("io/dataset.py", "load_poses"),
               ("io/dataset.py", "save_links"),
               ("io/dataset.py", "load_links"),
               ("io/synthetic.py", "out_and_back_trajectory"),
               ("runtime/pipeline.py", "_keypoints_3d"),
               ("mapping3d/occupancy.py", "OccupancyGrid"),
               ("mapping3d/occupancy.py", "_cam_vector"),
               ("vo/odometry.py", "OdomInfo"),
               ("kernels/rectify.py", "RectCamera"),
               ("kernels/rectify.py", "rect_map_fixed"),
               ("kernels/rectify.py", "rect_map_float"),
               ("optim/device.py", "graph_to_arrays"),
               ("optim/device.py", "classify_extra_edges"),
               ("runtime/dumps.py", "save_rect_image_pair"),
               ("runtime/dumps.py", "save_depth_image"),
               ("runtime/dumps.py", "save_eigenvalue"),
               ("runtime/dumps.py", "save_kpts2d"),
               ("runtime/dumps.py", "save_kpts3d"),
               ("runtime/dumps.py", "save_descriptor"),
               ("runtime/dumps.py", "save_rect_image_kpts"),
               ("runtime/dumps.py", "dump_frame"),
               ("calib/chessboard.py", "_nms_candidates"),
               ("calib/chessboard.py", "_subpix"),
               ("calib/chessboard.py", "_homography"),
               ("calib/chessboard.py", "_apply_h"),
               ("calib/chessboard.py", "render_chessboard"),
               ("calib/chessboard.py", "_rodrigues"),
               ("calib/chessboard.py", "project_points"),
               ("calib/chessboard.py", "_distort_inverse_grid"),
               ("calib/calibrate.py", "board_points"),
               ("calib/calibrate.py", "_v_ij"),
               ("calib/calibrate.py", "init_intrinsics"),
               ("calib/calibrate.py", "_fallback_K"),
               ("calib/calibrate.py", "init_extrinsics"),
               ("calib/calibrate.py", "_rvec"),
               ("calib/calibrate.py", "_lm"),
               ("calib/calibrate.py", "stereo_rectify"),
               ("cli/stereo_calib.py", "_pairs"),
               ("cli/stereo_capture.py", "_default_camera"),
               ("dist/mesh.py", "pad_edges"),
               ("dist/mesh.py", "shard_ba_problem")]
# copies the port adds to: the original's imports and definitions stay
# as they are, but for the methods named here (runtime/perf.py holds the
# port's span recorder, and Perf.span also records an event while it is
# on)
EXTENDED = {"runtime/perf.py": {"Perf": {"span"}}}
KERNELS = ["stereo_bm", "gftt", "orb", "median", "lr_check", "lm_refine"]
BACKEND = ["thomas"]


def _without_docstrings(tree):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def _code_without_docstrings(path):
    return _without_docstrings(ast.parse(open(path).read()))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_has_the_original_code(rel):
    port = os.path.join(ROOT, "tpuslam_torch", rel)
    orig = os.path.join(ROOT, "tpuslam", rel)
    if rel not in EXTENDED:
        assert _code_without_docstrings(port) == \
            _code_without_docstrings(orig)
        return
    have = {ast.dump(n) for n in ast.parse(open(port).read()).body}
    for node in ast.parse(open(orig).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            but = EXTENDED[rel].get(node.name, ())
            assert _definition(port, node.name, but) == \
                _definition(orig, node.name, but)
        elif not isinstance(node, ast.Expr):        # the docstring
            assert ast.dump(node) in have


def test_native_loader_is_the_original():
    """The port's native decoder is tpuslam's loader.cpp, byte for byte
    (the port builds its own copy: it does not call into tpuslam/)."""
    with open(os.path.join(ROOT, "tpuslam_torch", "csrc", "loader.cpp"),
              "rb") as f, open(os.path.join(ROOT, "tpuslam", "native",
                                            "loader.cpp"), "rb") as g:
        assert f.read() == g.read()


def _definition(path, name, but=()):
    """The code of top-level function or class `name` of `path`,
    docstrings and the class's methods named in `but` aside."""
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and \
                node.name == name:
            node.body = [n for n in node.body
                         if getattr(n, "name", None) not in but]
            return _without_docstrings(node)
    raise KeyError(name)


@pytest.mark.parametrize("rel, name", COPIED_DEFS)
def test_copied_definition_has_the_original_code(rel, name):
    assert _definition(os.path.join(ROOT, "tpuslam_torch", rel), name) == \
        _definition(os.path.join(ROOT, "tpuslam", rel), name)


def _as_tree(obj):
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _as_tree(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if hasattr(obj, "value") and hasattr(obj, "name"):       # Enum
        return (type(obj).__name__, obj.value)
    return obj


def test_config_equal_field_by_field():
    from tpuslam import config as J
    from tpuslam_torch import config as T
    assert _as_tree(T.SlamConfig()) == _as_tree(J.SlamConfig())
    slice_j = J.SlamConfig().replace(
        bm=J.StereoBMConfig(disp12_max_diff=-1),
        pnp=J.PnPConfig(refine_iterations=0))
    got = convert.config_from_reference(slice_j)
    assert isinstance(got, T.SlamConfig)
    assert _as_tree(got) == _as_tree(slice_j)
    assert got.bm.disp12_max_diff == -1 and got.pnp.refine_iterations == 0
    for app in J.AppMode:
        assert _as_tree(T.preset(T.AppMode(app.value))) == \
            _as_tree(J.preset(app))


def test_transform_values(rng):
    from tpuslam.geometry import transform as J
    from tpuslam_torch.geometry import transform as T
    for _ in range(5):
        v = rng.normal(0, 0.5, 6)
        a, b = J.from_rpy_xyz(*v), J.from_rpy_xyz(*rng.normal(0, 0.5, 6))
        np.testing.assert_array_equal(T.from_rpy_xyz(*v), a)
        np.testing.assert_array_equal(T.compose(a, b), J.compose(a, b))
        np.testing.assert_array_equal(T.inverse(a), J.inverse(a))
        np.testing.assert_array_equal(T.get_rpy(a), J.get_rpy(a))
        np.testing.assert_array_equal(T.rot_to_quat(a[:3, :3]),
                                      J.rot_to_quat(a[:3, :3]))
        pts = rng.normal(0, 3, (7, 3)).astype(np.float32)
        np.testing.assert_array_equal(T.transform_points(a, pts),
                                      J.transform_points(a, pts))
    np.testing.assert_array_equal(T.NULL, J.NULL)


def test_camera_values(tmp_path, rng):
    from tpuslam.geometry import camera as J
    from tpuslam_torch.geometry import camera as T
    calib = tmp_path / "calib.txt"
    calib.write_text(
        "P0: 7.188560e+02 0 6.071928e+02 0 0 7.188560e+02 1.852157e+02 0 "
        "0 0 1 0\nP1: 7.188560e+02 0 6.071928e+02 -3.861448e+02 0 "
        "7.188560e+02 1.852157e+02 0 0 0 1 0\n")
    for resize in (False, True):
        j = J.StereoCameraModel.load_kitti(str(calib), do_resize=resize)
        t = T.StereoCameraModel.load_kitti(str(calib), do_resize=resize)
        np.testing.assert_array_equal(t.P_l, j.P_l)
        np.testing.assert_array_equal(t.P_r, j.P_r)
        assert (t.width, t.height, t.baseline()) == \
            (j.width, j.height, j.baseline())
        np.testing.assert_array_equal(t.local_transform, j.local_transform)
        c = convert.camera_from_reference(j)
        np.testing.assert_array_equal(c.K_l, j.K_l)
        pts = rng.uniform(0, 300, (9, 2))
        disp = rng.uniform(-2, 60, 9)
        np.testing.assert_array_equal(
            T.project_disparity_to_3d(pts, disp, t),
            J.project_disparity_to_3d(pts, disp, j))


def test_kitti_metric_values(rng):
    from tpuslam.geometry import kitti_metric as J
    from tpuslam_torch.geometry import kitti_metric as T
    from tpuslam.geometry.transform import compose, from_rpy_xyz
    gt, est = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for _ in range(140):
        step = from_rpy_xyz(1.4, 0, 0, 0, 0, 0.003)
        gt.append(compose(gt[-1], step))
        est.append(compose(est[-1], from_rpy_xyz(
            *(np.array([1.4, 0, 0, 0, 0, 0.003]) +
              rng.normal(0, 1e-3, 6)))))
    assert T.calc_kitti_sequence_errors(gt, est) == \
        J.calc_kitti_sequence_errors(gt, est)
    assert T.ate_rmse(gt, est) == J.ate_rmse(gt, est)


def test_frame_and_odominfo_fields():
    from tpuslam.vo.frame import Frame as JFrame
    from tpuslam.vo.odometry import OdomInfo as JInfo
    from tpuslam_torch.vo.frame import Frame as TFrame
    from tpuslam_torch.vo.odometry import OdomInfo as TInfo
    for t, j in ((TFrame, JFrame), (TInfo, JInfo)):
        assert [(f.name, str(f.type)) for f in dataclasses.fields(t)] == \
            [(f.name, str(f.type)) for f in dataclasses.fields(j)]
    a, b = TInfo(), JInfo()
    np.testing.assert_array_equal(a.covariance, b.covariance)
    np.testing.assert_array_equal(a.pose, b.pose)


def test_import_leaves_jax_out():
    """Importing the port, its main path, its batch and realtime apps, its
    depth engines, its pose-graph device back end, checkpoints and replay
    included, and its tool apps (kernel test, self-tests, calibration,
    capture) and its multi-device layer (mesh, multi-process VO,
    partitioned map, slam_multihost, the rank worker), loads no JAX, no
    tpuslam and no Pillow."""
    code = ("import sys; import tpuslam_torch; "
            "import tpuslam_torch.runtime.fast_pipeline, "
            "tpuslam_torch.io.synthetic, tpuslam_torch.convert, "
            "tpuslam_torch.mapping.mapper, tpuslam_torch.mapping.ba_window, "
            "tpuslam_torch.mapping.chunk_dict, tpuslam_torch.optim, "
            "tpuslam_torch.optim.ba, tpuslam_torch.cli.slam_batch, "
            "tpuslam_torch.mapping3d, tpuslam_torch.io.dataset, "
            "tpuslam_torch.io.native_loader, tpuslam_torch.io.resize, "
            "tpuslam_torch.cli.slam_realtime, tpuslam_torch.kernels.sgbm, "
            "tpuslam_torch.kernels.lk_stereo, tpuslam_torch.kernels.rectify, "
            "tpuslam_torch.runtime.telemetry, tpuslam_torch.optim.device, "
            "tpuslam_torch.runtime.checkpoint, tpuslam_torch.runtime.logger, "
            "tpuslam_torch.cli.optimize_replay, tpuslam_torch.calib, "
            "tpuslam_torch.cli.kernel_test, tpuslam_torch.cli.hw_test, "
            "tpuslam_torch.cli.stereo_calib, "
            "tpuslam_torch.cli.stereo_capture, tpuslam_torch.dist, "
            "tpuslam_torch.runtime.dumps, tpuslam_torch.runtime.frame_meas, "
            "tpuslam_torch.io.imu, tpuslam_torch.io.patterns, "
            "tpuslam_torch.dist.multihost, "
            "tpuslam_torch.dist.partitioned_map, "
            "tpuslam_torch.cli.slam_multihost, "
            "tpuslam_torch.tools.dist_worker; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tpuslam', 'PIL')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)


def test_no_jax_or_tpuslam_import_in_port():
    import re
    pat = re.compile(r"^\s*(import\s+(jax|tpuslam|PIL)\b(?!_)|"
                     r"from\s+(jax|tpuslam|PIL)\b(?!_))", re.M)
    pkg = os.path.join(ROOT, "tpuslam_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                src = open(os.path.join(dirpath, name)).read()
                assert not pat.search(src), os.path.join(dirpath, name)
    smoke = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert not pat.search(smoke)


def test_precision_pinned():
    """Twin of test_precision_guard.py: no TF32 anywhere."""
    assert tpuslam_torch is not None and tpuslam is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _kernel_cases():
    """name -> (kernel wrapper, dispatcher, CPU arguments) for K1-K7."""
    from tpuslam_torch.config import StereoBMConfig
    from tpuslam_torch.kernels import stereo_bm as BM, gftt as G, orb as O
    from tpuslam_torch.kernels import pnp as P
    from tpuslam_torch.optim import device as DEV
    from tpuslam_torch.vo import fused as F
    img = torch.zeros((1, 40, 48), dtype=torch.uint8)
    img[:, 10:20, 12:30] = 200
    cfg = StereoBMConfig(disp12_max_diff=-1, num_disparities=16,
                         block_size=5)
    kp = torch.full((1, 8, 2), 20.0)
    valid = torch.ones((1, 8), dtype=torch.bool)
    a = torch.rand(1, 32)
    m = torch.rand(1, 32) < 0.5
    disp = torch.full((1, 40, 48), 80, dtype=torch.int16)
    minsad = torch.zeros((1, 40, 48), dtype=torch.int32)
    obj = torch.rand(16, 3) + torch.tensor([0.0, 0.0, 5.0])
    lm = (obj, torch.rand(16, 2) * 100, torch.ones(16),
          torch.ones(16, dtype=torch.bool), torch.eye(3), torch.zeros(3),
          torch.zeros(3))
    blocks = torch.eye(6).repeat(4, 1, 1) * 4.0
    thomas = (blocks, blocks[:3] * 0.5, torch.ones(4, 6, 13),
              torch.tensor(0.1))
    return {
        "stereo_bm": (BM.stereo_bm_cuda, BM.stereo_bm, (img, img, cfg)),
        "gftt": (G.gftt_response_dil_cuda,
                 lambda i: G.gftt_candidates(i, 0.01, 3, 64), (img,)),
        "orb": (O.orb_descriptors_cuda, O.orb_descriptors_const_angle,
                (img, kp, valid)),
        "median": (F.masked_median2_cuda, F.masked_median2, (a, a, m)),
        "lr_check": (BM.lr_check_cuda, BM.lr_check,
                     (disp, minsad, StereoBMConfig())),
        "lm_refine": (P.refine_lm_errors_cuda, P.refine_lm_with_errors_auto,
                      lm),
        "thomas": (DEV.thomas_solve_cuda, DEV.thomas_solve, thomas),
    }


@pytest.mark.parametrize("name", KERNELS + BACKEND)
def test_kernel_wrapper_refuses_cpu_tensors(name):
    """A kernel wrapper checks its arguments before any build or launch."""
    from tpuslam_torch.kernels import _cuda
    kernel, _, args = _kernel_cases()[name]
    _cuda.reset_counters()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel(*args)
    assert _cuda.LAUNCHES[name] == 0


@pytest.mark.parametrize("name", KERNELS + BACKEND)
def test_dispatch_takes_plain_version_on_cpu(name):
    """On a CPU tensor the dispatcher runs the plain version (counted
    once) and launches nothing."""
    from tpuslam_torch.kernels import _cuda
    _, dispatch, args = _kernel_cases()[name]
    _cuda.reset_counters()
    dispatch(*args)
    assert _cuda.PLAIN_CALLS[name] == 1
    assert sum(_cuda.LAUNCHES.values()) == 0


@pytest.mark.parametrize("name", ["orb_blur", "orb_tests"])
def test_orb_half_wrapper_refuses_cpu_tensors(name):
    """K3's halves as tool launchers check their arguments before any
    build or launch, as K3's wrapper does."""
    from tpuslam_torch.kernels import _cuda, orb as O
    img = torch.zeros((1, 40, 48), dtype=torch.uint8)
    kp = torch.full((1, 8, 2), 20.0)
    valid = torch.ones((1, 8), dtype=torch.bool)
    call = {"orb_blur": lambda: O.orb_blur_cuda(img),
            "orb_tests": lambda: O.orb_tests_cuda(img, kp, valid)}[name]
    _cuda.reset_counters()
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
    assert sum(_cuda.LAUNCHES.values()) == 0


@pytest.mark.parametrize("argv, match", [
    ([], "no CUDA device"), (["gftt:32"], "unknown shape"),
    (["lr_check:4x13", "lr_check:4"], "unknown shape"),
    (["gftt:16x2x2", "lr_check:4x13"], "no CUDA device")])
def test_shape_sweep_refuses(monkeypatch, argv, match):
    """The shape sweep refuses an unknown kernel or a shape without one
    positive integer per field of its kernel (K2's strip has three, K5's
    rows two), and exits with an error where there is no CUDA device,
    before any build."""
    from tpuslam_torch.tools import shape_sweep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        shape_sweep.main(argv)


def test_kernel_table_names_every_kernel():
    """Every launcher has a signature, counters and a source; the phase
    harness is a tool in K1's file and K3's two halves tools in K3's, not
    kernels of the main path; K7 is the pose graph's device back end's own
    group, built like the rest and with FMA contraction off."""
    from tpuslam_torch.kernels import _cuda
    assert list(_cuda.KERNELS) == KERNELS
    assert list(_cuda.TOOLS) == ["stereo_bm_phase", "orb_blur", "orb_tests"]
    assert list(_cuda.BACKEND) == BACKEND
    names = KERNELS + list(_cuda.TOOLS) + BACKEND
    assert list(_cuda.ALL) == names
    assert _cuda.EXTRA_FLAGS["thomas"] == ["-fmad=false"]
    assert set(_cuda.SIGNATURES) == set(names)
    assert set(_cuda.LAUNCHES) == set(_cuda.PLAIN_CALLS) == set(names)
    assert _cuda.source("stereo_bm_phase") == "stereo_bm"
    assert _cuda.source("orb_blur") == _cuda.source("orb_tests") == "orb"
    for name in names:
        assert os.path.exists(os.path.join(ROOT, "tpuslam_torch", "csrc",
                                           f"{_cuda.source(name)}.cu"))


def _entry_points():
    from tpuslam_torch import convert
    from tpuslam_torch.cli import slam_batch, slam_realtime
    from tpuslam_torch.kernels import lk_stereo, rectify, sgbm
    from tpuslam_torch.io.synthetic import write_sequence
    from tpuslam_torch.mapping3d import occupancy
    from tpuslam_torch.runtime import pipeline
    from tpuslam_torch.vo.odometry import Odometry
    from tpuslam_torch.io.synthetic import BoxWorld, make_sequence
    from tpuslam_torch.kernels.pnp import solve_pnp_ransac
    from tpuslam_torch.mapping import ba_window
    from tpuslam_torch.mapping.chunk_dict import ChunkDictDriver
    from tpuslam_torch.mapping.dictionary import VWDictionary
    from tpuslam_torch.mapping.mapper import Mapper
    from tpuslam_torch.optim import run_optimize, run_optimize_robust
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    from tpuslam_torch.vo import fused, registration
    from tpuslam_torch import calib
    from tpuslam_torch.calib import chessboard
    from tpuslam_torch.cli import hw_test, kernel_test, stereo_calib
    from tpuslam_torch.cli import stereo_capture
    from tpuslam_torch.dist import mesh, multihost, partitioned_map
    from tpuslam_torch.cli import slam_multihost
    from tpuslam_torch.io.synthetic import photo_pyramid
    return {
        "FastSlamPipeline": FastSlamPipeline.__init__,
        "make_sequence": make_sequence,
        "BoxWorld.render": BoxWorld.render,
        "make_frontend_fn": fused.make_frontend_fn,
        "make_fused_chunk_fn": fused.make_fused_chunk_fn,
        "carry_from_reference": convert.carry_from_reference,
        "dictionary_from_reference": convert.dictionary_from_reference,
        "Mapper": Mapper.__init__,
        "VWDictionary": VWDictionary.__init__,
        "ChunkDictDriver": ChunkDictDriver.__init__,
        "compute_transform": registration.compute_transform,
        "solve_pnp_ransac": solve_pnp_ransac,
        "refine_trajectory_ba": ba_window.refine_trajectory_ba,
        "refine_trajectory_global_ba": ba_window.refine_trajectory_global_ba,
        "Odometry": Odometry.__init__,
        "extract_features": pipeline.extract_features,
        "frontend_dispatch": pipeline.frontend_dispatch,
        "slam_batch.run": slam_batch.run,
        "slam_realtime.run": slam_realtime.run,
        "sgbm": sgbm.sgbm,
        "lk_stereo": lk_stereo.lk_stereo,
        "compute_correspondences": lk_stereo.compute_correspondences,
        "StereoRectifier": rectify.StereoRectifier.__init__,
        "StereoRectifier.from_reference_calib":
            rectify.StereoRectifier.from_reference_calib,
        "write_sequence": write_sequence,
        "build_occupancy_grid_map": occupancy.build_occupancy_grid_map,
        "insert_depth_frame": occupancy.insert_depth_frame,
        "run_optimize": run_optimize,
        "run_optimize_robust": run_optimize_robust,
        "kernel_test.run": kernel_test.run,
        "hw_test.test_patterns": hw_test.test_patterns,
        "hw_test.test_timing": hw_test.test_timing,
        "frontend_one": mesh.frontend_one,
        "find_chessboard": chessboard.find_chessboard,
        "calibrate_camera": calib.calibrate_camera,
        "stereo_calibrate": calib.stereo_calibrate,
        "stereo_calib.run": stereo_calib.run,
        "stereo_capture.run": stereo_capture.run,
        "photo_pyramid": photo_pyramid,
        "make_mesh": mesh.make_mesh,
        "initialize": multihost.initialize,
        "extract_block_features": multihost.extract_block_features,
        "vo_from_features": multihost.vo_from_features,
        "run_multihost_vo": multihost.run_multihost_vo,
        "ShardedVWDictionary": partitioned_map.ShardedVWDictionary.__init__,
        "PartitionedMapper": partitioned_map.PartitionedMapper.__init__,
        "sharded_dictionary_from_reference":
            convert.sharded_dictionary_from_reference,
        "slam_multihost.run": slam_multihost.run,
    }


@pytest.mark.parametrize("name", ["FastSlamPipeline", "make_sequence",
                                  "BoxWorld.render", "make_frontend_fn", "make_fused_chunk_fn",
                                  "carry_from_reference",
                                  "dictionary_from_reference", "Mapper",
                                  "VWDictionary", "ChunkDictDriver",
                                  "compute_transform", "solve_pnp_ransac",
                                  "refine_trajectory_ba",
                                  "refine_trajectory_global_ba", "Odometry",
                                  "extract_features", "frontend_dispatch",
                                  "slam_batch.run", "write_sequence",
                                  "slam_realtime.run", "sgbm", "lk_stereo",
                                  "compute_correspondences",
                                  "StereoRectifier",
                                  "StereoRectifier.from_reference_calib",
                                  "build_occupancy_grid_map",
                                  "insert_depth_frame", "run_optimize",
                                  "run_optimize_robust", "kernel_test.run",
                                  "hw_test.test_patterns",
                                  "hw_test.test_timing",
                                  "frontend_one", "find_chessboard",
                                  "calibrate_camera", "stereo_calibrate",
                                  "stereo_calib.run", "stereo_capture.run",
                                  "photo_pyramid", "make_mesh",
                                  "initialize", "extract_block_features",
                                  "vo_from_features", "run_multihost_vo",
                                  "ShardedVWDictionary", "PartitionedMapper",
                                  "sharded_dictionary_from_reference",
                                  "slam_multihost.run"])
def test_entry_point_defaults_to_the_card(name):
    """Every entry point runs on the card unless the caller asks for the
    CPU (read from the signature: nothing is built here)."""
    import inspect
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_logger_prints_what_tpuslam_prints(tmp_path, capsys, monkeypatch):
    """The port's Logger (a copy) prints, buffers and flushes the lines
    tpuslam's does, the milliseconds since its start aside, and raises
    SlamError on an error after flushing log.txt."""
    import re
    from tpuslam.runtime import logger as J
    from tpuslam_torch.runtime import logger as T
    monkeypatch.chdir(tmp_path)
    out = {}
    for pkg in (J, T):
        log = pkg.Logger(level=pkg.LOG_LEVEL_DEBUG)
        log.debug("d")
        log.info("i")
        log.warn("w")
        with pytest.raises(pkg.SlamError, match="test_torch_config.py:.* e"):
            log.error("e")
        printed = capsys.readouterr().out
        flushed = open("log.txt").read()
        quiet = pkg.Logger(quiet=True)
        quiet.info("hidden")
        assert capsys.readouterr().out == ""
        out[pkg] = [re.sub(r"^(\[\w+\]) +[\d.]+ ", r"\1 ", line)
                    for line in (printed + flushed).splitlines()]
    assert out[T] == out[J]
    assert len(out[T]) == 8 and out[T][0].startswith("[DEBUG] ")
    assert out[T][3].startswith("[ERROR] test_torch_config.py:")
