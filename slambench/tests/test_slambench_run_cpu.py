"""A run of the harness on the CPU at a small size, past its look for a
card: the sound program comes out correct, the program with each fault
that a cell can have comes out not correct, and the control (the
reference one precision step down) fails the check's numbers.

The small size: 320x240 at the same focal length per pixel, 10 frames,
chunks of 5, one node frame checked; the limits are the configuration's
but for the inlier count, which scales with the image, and the KITTI
segment error, which needs 100 m of drive."""

from __future__ import annotations

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from slambench import check, harness, run, world
from slambench.faults import (answer_altered, half_batch_left_out,
                              pose_unchanged, reference_loads_jax)

CONFIG = run.load_json(run.HERE, "configs", "kitti-bm.json")
TRAFFIC = run.load_json(run.HERE, "traffic", "single.json")
SEED = 3_000_000_007          # past 32 signed bits, as the driver's are
SMALL_INLIERS = 50


def small_spec(config=CONFIG):
    config = copy.deepcopy(config)
    config["camera"].update(width=320, height=240,
                            f=config["camera"]["f"] * 320 / 1241)
    config["sequence_frames"] = 10
    config["pipeline"]["chunk"] = 5
    config["limits"]["inliers_min"] = [">=", SMALL_INLIERS]
    # 14 m of drive hold no 100 m segment of the KITTI metric
    del config["limits"]["t_err_pct"]
    # the card's deployment pins a stream to two host cores; not here
    traffic = dict(copy.deepcopy(TRAFFIC), check_frames=1, png_threads=2,
                   cores_per_stream=0)
    bench = json.load(open(os.path.join(os.path.dirname(run.HERE),
                                        "BENCHMARK.json")))
    spec = run.resolve(bench, "bm-drive")
    spec.update(config=config, traffic=traffic)
    return spec


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_small(faults=()):
    spec = small_spec()
    t = time.perf_counter()
    # one chunk is dispatched before the window closes
    g = harness._run_local(spec, SEED, 1.0, False, t, device="cpu",
                           faults=faults)
    return harness.run(spec, SEED, 1.0, False, t, gathered=g)


def test_sound_run_is_correct():
    res = run_small()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 5 and res["failed"] == 0
    assert res["frames_checked"] == 1
    assert list(res)[-2:] == ["checks", "_rows"]
    assert {"stream_fps", "setup_s", "peak_mem_gib"} >= set(res["metrics"])


@pytest.mark.parametrize("fault,caught_by", [
    (pose_unchanged, "ate_m"), (half_batch_left_out, "lost"),
    (answer_altered, "disp_px")])
def test_fault_is_not_correct(fault, caught_by):
    res = run_small((fault,))
    assert not res["correct"]
    name, value, op, limit = next(r for r in res["_rows"]
                                  if r[0] == caught_by)
    assert not (value <= limit if op == "<=" else value >= limit)


@pytest.mark.parametrize("config,size", [("kitti-bm", (320, 240)),
                                         ("kitti-sgbm", (320, 96))])
def test_control_fails_the_check(config, size):
    conf = run.load_json(run.HERE, "configs", f"{config}.json")
    conf["camera"].update(width=size[0], height=size[1])
    conf["sequence_frames"] = 10
    from slambench import control
    got = control.readings(conf, TRAFFIC["log"], SEED, 1, "cpu")
    ok, rows = check.judge(dict(got, **{k: 0 for k in conf["limits"]
                                       if k not in got}),
                           conf["limits"])
    assert not ok
    assert got["disp_px"] > 0


def test_two_stream_fleet_on_the_cpu():
    """Worker processes, the barrier and the merge of their reports."""
    spec = small_spec()
    spec["traffic"]["streams"] = 2
    t = time.perf_counter()
    g = harness._run_fleet(spec, SEED, 1.0, False, t, device="cpu")
    res = harness.run(spec, SEED, 1.0, False, t, gathered=g)
    assert res["correct"], res["checks"]
    assert sorted(g.window) == [0, 1] and sorted(g.checks) == [0, 1]
    assert g.modules == []
    assert res["frames_checked"] == 2
    assert 0 < g.setup_s < 300


def test_fleet_worker_that_loads_jax_after_the_window_gives_no_result():
    """A worker whose check loads a module named jax, after its window
    report went out clean: the run refuses to give a result."""
    spec = small_spec()
    spec["traffic"]["streams"] = 2
    t = time.perf_counter()
    g = harness._run_fleet(spec, SEED, 1.0, False, t, device="cpu",
                           faults=(reference_loads_jax,))
    assert all(not w["modules"] for w in g.window.values())
    assert g.modules == ["jax"]
    with pytest.raises(harness.StreamFailed, match="jax"):
        harness.run(spec, SEED, 1.0, False, t, gathered=g)


def test_world_seed_takes_any_whole_number():
    seeds = {world.world_seed(s, i) for s in (0, 1, 2 ** 31 + 5, 10 ** 30)
             for i in range(4)}
    assert len(seeds) == 16
    assert all(0 <= s < 2 ** 31 for s in seeds)


def test_reference_equals_the_program_on_the_cpu():
    """The reference is an independent copy: on the CPU, where the
    program runs its plain versions, the two agree exactly."""
    from tpuslam_torch.vo.fused import make_frontend_fn, FusedShapes
    from slambench.stream import slam_config
    from slambench import logfiles
    spec = small_spec()
    cam, pl = spec["config"]["camera"], spec["config"]["pipeline"]
    poses = world.forward_trajectory(10, 1.4, 0.003)
    left, right, _ = world.render_log(poses, 5, cam["width"], cam["height"],
                                      cam["f"], cam["baseline"], "cpu",
                                      frames=[4])
    import tempfile
    from tpuslam_torch.geometry.camera import StereoCameraModel
    with tempfile.TemporaryDirectory() as d:
        calib = logfiles.write_calib(d, cam["width"], cam["height"],
                                     cam["f"], cam["baseline"])
        camera = StereoCameraModel.load_kitti(
            calib, image_size=(cam["width"], cam["height"]))
        want = check.reference_frontend(left.numpy(), right.numpy(), pl,
                                        calib, "cpu")[0]
    fe = make_frontend_fn(camera, slam_config(pl),
                          FusedShapes(chunk=1, capacity=pl["capacity"]),
                          device="cpu")
    feats = {k: v.numpy() for k, v in fe(left, right).items()}
    got = check.program_frame(feats, 0)
    assert check.compare(got, want) == dict(disp_px=0, kpt_diff=0,
                                            desc_bits=0, pts3d_err=0.0)
    assert len(want["kpts"]) > 100
    assert np.isfinite(want["pts3d"]).any()
