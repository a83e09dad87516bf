"""tpuslam_torch's realtime app (cli/slam_realtime.py), its telemetry
(runtime/telemetry.py) and the per-frame front end's other depth engines.

The realtime app against the port's own batch app on a 6-frame 320x240
sequence (tpuslam-written, f = 250, as test_torch_slam_batch.py) with a
small Mapper that closes a loop, the same RANSAC draws injected into both
(tests/test_realtime.py's claims, on the port): identical VO poses,
optimized poses within 1e-5; pipelined equal to unpipelined; asynchronous
loop closure joins and equals the synchronous one; the telemetry ring.
Then `extract_features` with "sgbm", "lk" and "cv_bm" against tpuslam's on
one pair: SGBM's disparity is cv2.filterSpeckles of tpuslam's unspeckled
map (x16 range; tpuslam's fixed 16 speckle rounds do not converge,
ROADMAP C), LK's finite masks agree on at least 99 % of the keypoints and
its 3D points within 1e-4 m; cv_bm's disparity and 3D exactly.
Keypoints and descriptors as test_torch_slam_batch.py holds them.
"""

import dataclasses
import json
import os

import cv2
import numpy as np
import pytest

from tpuslam.config import DepthMethod, MapperConfig, SGBMConfig, SlamConfig
from tpuslam_torch import convert


def _draws(seed):
    return np.random.default_rng(seed).random((300, 6), dtype=np.float32)


def _cfg(**kw):
    return convert.config_from_reference(dataclasses.replace(
        SlamConfig(**kw), mapper=MapperConfig(map_update=2, max_stm_size=2,
                                              loop_thr=0.05)))


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    from tpuslam.io.synthetic import make_sequence
    out = str(tmp_path_factory.mktemp("rt_seq"))
    make_sequence(out, n_frames=6, width=320, height=240, f=250.0,
                  baseline=0.54, speed=0.4, yaw_rate=0.002, seed=3)
    return out


@pytest.fixture(scope="module")
def runs(seq):
    """The port's batch run and its realtime run (pipelined, asynchronous
    loop closure, telemetry on)."""
    from tpuslam_torch.cli import slam_batch, slam_realtime
    b = slam_batch.run(seq, _cfg(), quiet=True,
                       out_dir=os.path.join(seq, "batch"), device="cpu",
                       draws_fn=_draws)
    r = slam_realtime.run(seq, _cfg(), quiet=True,
                          out_dir=os.path.join(seq, "rt"), device="cpu",
                          draws_fn=_draws, pipelined=True, async_lc=True,
                          telemetry_dir=os.path.join(seq, "telemetry"))
    return b, r


def test_realtime_matches_batch(runs, seq):
    b, r = runs
    assert r["n_frames"] == b["n_frames"] == 6
    np.testing.assert_array_equal(r["vo_poses"], b["vo_poses"])
    assert sorted(r["optimized"]) == sorted(b["optimized"])
    for nid in b["optimized"]:
        np.testing.assert_allclose(r["optimized"][nid], b["optimized"][nid],
                                   rtol=0, atol=1e-5)
    assert r["n_loop_closures"] == b["n_loop_closures"] >= 1
    assert r["latency_ms_p95"] >= r["latency_ms_p50"] > 0 and r["fps"] > 0
    assert np.isfinite(r["ate_m"])
    for name in ("optimized_poses.csv", "perf_time.csv"):
        assert os.path.exists(os.path.join(seq, "rt", name))


def test_pipelined_matches_unpipelined(runs, seq):
    from tpuslam_torch.cli import slam_realtime
    u = slam_realtime.run(seq, _cfg(), quiet=True,
                          out_dir=os.path.join(seq, "unpiped"),
                          device="cpu", draws_fn=_draws, pipelined=False,
                          async_lc=True)
    np.testing.assert_array_equal(u["vo_poses"], runs[1]["vo_poses"])


def test_async_lc_joins_cleanly(runs, seq):
    """Loop closure on the worker thread (the realtime run) joins before
    the graph is read and gives the synchronous run's loop closures."""
    from tpuslam_torch.cli import slam_realtime
    s = slam_realtime.run(seq, _cfg(), quiet=True,
                          out_dir=os.path.join(seq, "sync"), device="cpu",
                          draws_fn=_draws, pipelined=True, async_lc=False)
    a = runs[1]
    np.testing.assert_array_equal(a["vo_poses"], s["vo_poses"])
    assert a["n_loop_closures"] == s["n_loop_closures"]
    assert a["mapper"].loop_closures == s["mapper"].loop_closures
    assert a["mapper"]._lc_thread is None        # joined


def _frame_id(tdir):
    return json.load(open(os.path.join(tdir, "latest.json")))["frame_id"]


def test_telemetry_stream(runs, seq):
    """The ring files and the atomic latest.json pointer: a published
    frame's rect image is that frame's left image and its disparity view
    has the frame's size.  (`close` stops the writer, which may skip a
    frame still queued, in tpuslam's sink as in this one.)"""
    from tpuslam_torch.io.png import read_png
    tdir = os.path.join(seq, "telemetry")
    stats = runs[1]["telemetry"]
    assert 1 <= stats["published"] and \
        stats["published"] + stats["dropped"] <= 6
    latest = json.load(open(os.path.join(tdir, "latest.json")))
    assert 0 <= latest["frame_id"] <= 5
    assert latest["slot"] == latest["frame_id"] % 8
    rect = read_png(os.path.join(tdir, latest["rect"]))
    want = read_png(os.path.join(seq, "image_0", sorted(
        os.listdir(os.path.join(seq, "image_0")))[latest["frame_id"]]))
    np.testing.assert_array_equal(rect, want)
    assert read_png(os.path.join(tdir, latest["disp"])).shape == (240, 320)
    assert not os.path.exists(os.path.join(tdir, ".latest.tmp"))


def test_telemetry_matches_reference(tmp_path):
    """The port's sink writes the images tpuslam's (Pillow) writes, and
    the same latest.json."""
    import time
    from PIL import Image
    from tpuslam.runtime.telemetry import TelemetrySink as JSink
    from tpuslam_torch.runtime.telemetry import TelemetrySink as TSink
    rng = np.random.default_rng(1)
    left = rng.integers(0, 256, (24, 40)).astype(np.uint8)
    disp = rng.integers(-16, 64 * 16, (24, 40)).astype(np.int16)
    for name, sink in (("j", JSink), ("t", TSink)):
        s = sink(str(tmp_path / name), ring=4)
        s.publish(6, 0.6, left=left, disparity=disp)
        deadline = time.monotonic() + 30
        while s.stats["published"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        s.close()
        assert s.stats == {"published": 1, "dropped": 0}
        assert not s._thread.is_alive()
    for f in ("rect_2.png", "disp_2.png"):
        a = np.asarray(Image.open(tmp_path / "j" / f))
        b = np.asarray(Image.open(tmp_path / "t" / f))
        np.testing.assert_array_equal(b, a)
    assert json.load(open(tmp_path / "t" / "latest.json")) == \
        json.load(open(tmp_path / "j" / "latest.json"))


def test_telemetry_drops_the_oldest(tmp_path, monkeypatch):
    """publish never blocks: while the writer is busy, each new frame
    replaces the queued one and counts a drop; the newest is written."""
    import threading
    import time
    from tpuslam_torch.io import png
    from tpuslam_torch.runtime import telemetry
    gate = threading.Event()
    write = png.write_png

    def held_write(*args, **kw):
        gate.wait(30)
        return write(*args, **kw)
    monkeypatch.setattr(png, "write_png", held_write)
    sink = telemetry.TelemetrySink(str(tmp_path), ring=4)
    img = np.zeros((8, 8), np.uint8)
    sink.publish(0, 0.0, left=img)
    deadline = time.monotonic() + 30
    while not sink._q.empty() and time.monotonic() < deadline:
        time.sleep(0.01)                 # the writer holds frame 0
    t0 = time.monotonic()
    for i in range(1, 5):
        sink.publish(i, 0.1 * i, left=img + i)
    assert time.monotonic() - t0 < 5
    gate.set()
    while sink.stats["published"] < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    sink.close()
    assert sink.stats == {"published": 2, "dropped": 3}
    assert _frame_id(str(tmp_path)) == 4


def _camera(h, w, f=250.0, baseline=0.54):
    from tpuslam.geometry.camera import StereoCameraModel
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    P0 = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]], np.float64)
    P1 = P0.copy()
    P1[0, 3] = -f * baseline
    return StereoCameraModel(P_l=P0, P_r=P1, width=w, height=h)


SGBM_SMALL = SGBMConfig(min_disparity=0, num_disparities=64)


@pytest.fixture(scope="module")
def pair(seq):
    from tpuslam.io.dataset import StereoImageDataset
    ds = StereoImageDataset(left_dir=os.path.join(seq, "image_0"),
                            right_dir=os.path.join(seq, "image_1"))
    return ds[2]["left"], ds[2]["right"]


def _frames(pair, method):
    from tpuslam.runtime.pipeline import extract_features as JE
    from tpuslam_torch.runtime.pipeline import extract_features as TE
    kw = dict(depth_method=DepthMethod(method))
    if method == "sgbm":
        kw["sgbm"] = SGBM_SMALL
    cfg = SlamConfig(**kw)
    cam = _camera(*pair[0].shape)
    ref = JE(pair[0], pair[1], cam, cfg)
    got = TE(pair[0], pair[1], convert.camera_from_reference(cam),
             convert.config_from_reference(cfg), device="cpu")
    return ref, got


def _same_features(ref, got):
    np.testing.assert_array_equal(got.kpts[:, :2], ref.kpts[:, :2])
    flipped = np.unpackbits(got.desc ^ ref.desc, axis=1).sum(axis=1)
    assert (flipped <= 2).all() and (flipped > 0).mean() < 0.01


@pytest.mark.parametrize("method", ["sgbm", "lk", "cv_bm"])
def test_extract_features_matches_reference(pair, method):
    ref, got = _frames(pair, method)
    _same_features(ref, got)
    fin_r = np.isfinite(ref.kpts3d).all(axis=1)
    fin_g = np.isfinite(got.kpts3d).all(axis=1)
    if method == "lk":
        assert got.disparity is None and ref.disparity is None
        assert (fin_g == fin_r).mean() >= 0.99
        both = fin_g & fin_r
        assert both.sum() > 100
        np.testing.assert_allclose(got.kpts3d[both], ref.kpts3d[both],
                                   rtol=0, atol=1e-4)
        return
    if method == "sgbm":
        from tpuslam.kernels.sgbm import sgbm
        raw = np.asarray(sgbm(pair[0], pair[1], SGBM_SMALL,
                              with_speckle=False))
        want = raw.copy()
        cv2.filterSpeckles(want, (SGBM_SMALL.min_disparity - 1) * 16,
                           SGBM_SMALL.speckle_window_size,
                           SGBM_SMALL.speckle_range * 16)
        np.testing.assert_array_equal(got.disparity, want)
    else:
        np.testing.assert_array_equal(got.disparity, ref.disparity)
        np.testing.assert_array_equal(got.kpts3d, ref.kpts3d)
    xs, ys = got.kpts[:, 0].astype(int), got.kpts[:, 1].astype(int)
    same = got.disparity[ys, xs] == ref.disparity[ys, xs]
    assert same.mean() > 0.9 and fin_g.sum() > 100
    np.testing.assert_array_equal(fin_g[same], fin_r[same])
    np.testing.assert_allclose(got.kpts3d[same & fin_g],
                               ref.kpts3d[same & fin_r], rtol=0, atol=1e-5)
