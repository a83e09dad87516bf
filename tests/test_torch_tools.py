"""tpuslam_torch's tool apps against tpuslam's, on the CPU.

The xsbl2 prefilter, the seven SensorData dump hooks, the kernel A/B
harness (cli/kernel_test.py), the test patterns, the synthetic IMU and
the frame-timing twin with the hardware self-tests (cli/hw_test.py),
the per-frame device front end (dist/mesh.py's frontend_one), the
capture app (cli/stereo_capture.py) and the photo texture of
io/synthetic.py.

Tolerances: the prefilter, the patterns, the dumps' CSVs (byte for
byte) and PNGs (decoded) are exact; the float rectifier's warp to 1e-4
(tests/test_torch_rectify.py); the GFTT response to rtol 2e-6 / atol
1e-7 and the blur to one grey level, where XLA's CPU backend contracts
multiply-adds into FMAs (tests/test_torch_gftt.py, test_torch_orb.py);
photo-textured renders to one grey level on at most 1e-3 of the pixels
(tests/test_torch_synthetic.py).  The speckle pass: the port labels to
its fixpoint, so its disparity is cv2.filterSpeckles of tpuslam's
unspeckled map, and equals tpuslam's own wherever tpuslam's 16 rounds
converge (tests/test_torch_speckle.py).
"""

import contextlib
import io
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.config import StereoBMConfig as JCfg
from tpuslam.kernels import stereo_bm as JBM
from tpuslam_torch.io.png import read_png


FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PATTERNS = (1, 2, 3, 4, 5)
# a 64x96 crop of the fixture pair where tpuslam's 16 speckle rounds
# converge, and the whole pair, where they do not
CROP = (slice(100, 164), slice(200, 296))
GREY_TOL = dict(max_levels=1, max_share=1e-3)


def _decoded(path):
    return read_png(str(path))


def _grey_levels_close(got, ref):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= GREY_TOL["max_levels"]
    assert (d > 0).mean() <= GREY_TOL["max_share"]


def _reference_disparity(left, right, cfg=JCfg()):
    """(cv2.filterSpeckles of tpuslam's unspeckled StereoBM, tpuslam's
    speckled StereoBM, whether tpuslam's speckle rounds converged)."""
    raw = np.asarray(JBM.stereo_bm(left, right, cfg, with_speckle=False))
    filtered = (cfg.min_disparity - 1) * 16
    ref, conv = JBM.speckle_filter_with_flag(
        jnp.asarray(raw, jnp.int32), cfg.speckle_window_size,
        cfg.speckle_range, filtered)
    out = raw.copy()
    cv2.filterSpeckles(out, filtered, cfg.speckle_window_size,
                       cfg.speckle_range)
    return out, np.asarray(ref).astype(np.int16), bool(conv)


def _hold_disparity(got, left, right):
    want, ref, conv = _reference_disparity(left, right)
    np.testing.assert_array_equal(got, want)
    if conv:
        np.testing.assert_array_equal(got, ref)
    return conv


# ----------------------------------------------------------- xsbl2 prefilter
def test_prefilter_xsobel_hw_golden_and_reference(stereo_pair, rng):
    """Bit-equal to the shipped golden PL data on both rectified frames,
    and to tpuslam's on them, on random images and on a batch."""
    from tpuslam_torch.kernels.stereo_bm import prefilter_xsobel_hw
    for side, img in zip(("left", "right"), stereo_pair):
        got = prefilter_xsobel_hw(torch.as_tensor(img)).numpy()
        gold = np.load(os.path.join(FIXTURES, f"xsbl_{side}.npy"))
        np.testing.assert_array_equal(got, gold)
        np.testing.assert_array_equal(
            got, np.asarray(JBM.prefilter_xsobel_hw(img)))
    imgs = rng.integers(0, 256, (3, 7, 11)).astype(np.uint8)
    got = prefilter_xsobel_hw(torch.as_tensor(imgs)).numpy()
    for b in range(3):
        np.testing.assert_array_equal(
            got[b], np.asarray(JBM.prefilter_xsobel_hw(imgs[b])))


# ----------------------------------------------------------------- dumps
def _frame_inputs(rng):
    from tpuslam_torch.vo.frame import Frame
    h, w = 24, 32
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    right = rng.uniform(-3.0, 260.0, (h, w)).astype(np.float32)
    disp = rng.integers(-16, 64 * 16, (h, w)).astype(np.int16)
    eig = rng.uniform(-1e-4, 3e-3, (h, w)).astype(np.float32)
    kpts = np.concatenate([rng.uniform(-4, 36, (9, 2)),
                           rng.uniform(0, 1, (9, 1))], 1).astype(np.float32)
    kpts3d = rng.normal(0, 5, (9, 3)).astype(np.float32)
    desc = rng.integers(0, 256, (9, 32)).astype(np.uint8)
    frame = Frame(stamp=0.0, image_left=img, image_right=right,
                  disparity=disp, kpts=kpts, kpts3d=kpts3d, desc=desc)
    return dict(img=img, right=right, disp=disp, eig=eig, kpts=kpts,
                kpts3d=kpts3d, desc=desc, frame=frame)


DUMPS = {
    "rect_image_pair": lambda m, d, x: m.save_rect_image_pair(
        d, 3, x["img"], x["right"]),
    "depth_image": lambda m, d, x: m.save_depth_image(d, 3, x["disp"]),
    "eigenvalue": lambda m, d, x: m.save_eigenvalue(d, 3, x["eig"]),
    "kpts2d": lambda m, d, x: m.save_kpts2d(d, 3, x["kpts"]),
    "kpts3d": lambda m, d, x: m.save_kpts3d(d, 3, x["kpts3d"]),
    "descriptor": lambda m, d, x: m.save_descriptor(d, 3, x["desc"]),
    "rect_image_kpts": lambda m, d, x: m.save_rect_image_kpts(
        d, 3, x["img"], x["kpts"]),
    "dump_frame": lambda m, d, x: m.dump_frame(d, 3, x["frame"], x["eig"]),
}


def _same_dump_dirs(got_dir, ref_dir):
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for name in names:
        a, b = os.path.join(got_dir, name), os.path.join(ref_dir, name)
        if name.endswith(".png"):
            np.testing.assert_array_equal(_decoded(a), _decoded(b))
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), name


@pytest.mark.parametrize("hook", list(DUMPS))
def test_dump_hook(tmp_path, rng, hook):
    """Each hook writes tpuslam's files: CSVs byte for byte, PNGs that
    decode to tpuslam's images (float images truncated to uint8)."""
    from tpuslam.runtime import dumps as J
    from tpuslam_torch.runtime import dumps as T
    x = _frame_inputs(rng)
    DUMPS[hook](J, str(tmp_path / "ref"), x)
    DUMPS[hook](T, str(tmp_path / "got"), x)
    _same_dump_dirs(str(tmp_path / "got"), str(tmp_path / "ref"))


# ------------------------------------------------------------ kernel_test
@pytest.fixture(scope="module")
def kernel_tests(tmp_path_factory):
    """tpuslam's and the port's kernel_test.run on the golden pair and on
    a 64x96 crop of it (written as PNGs), with the port's stage arrays."""
    from tpuslam.cli import kernel_test as J
    from tpuslam_torch.cli import kernel_test as T
    from tpuslam_torch.io.png import write_png
    root = tmp_path_factory.mktemp("kernel_test")
    left = np.load(os.path.join(FIXTURES, "rect_left.npy"))
    right = np.load(os.path.join(FIXTURES, "rect_right.npy"))
    write_png(str(root / "l.png"), left[CROP])
    write_png(str(root / "r.png"), right[CROP])
    out = {}
    for case, paths in (("golden", (None, None)),
                        ("crop", (str(root / "l.png"), str(root / "r.png")))):
        arrays = {}
        got = T.run(*paths, out_dir=str(root / case / "got"), quiet=True,
                    device="cpu", arrays=arrays)
        ref = J.run(*paths, out_dir=str(root / case / "ref"), quiet=True)
        out[case] = (got, ref, arrays, root / case)
    return out


@pytest.mark.parametrize("case", ["golden", "crop"])
def test_kernel_test_report(kernel_tests, case):
    """The port's report is tpuslam's: every entry equal (the float
    warp's differences to 1e-4), the disparity's where tpuslam's speckle
    rounds converged; the disparity is cv2.filterSpeckles of tpuslam's
    unspeckled map, and equal to tpuslam's where it converged."""
    got, ref, arrays, _ = kernel_tests[case]
    assert list(got) == list(ref)
    for key in ref:
        if key == "rectify_hw_vs_float":
            assert got[key]["pass"] == ref[key]["pass"]
            for k in ("max_abs", "mean_abs"):
                assert got[key][k] == pytest.approx(ref[key][k], abs=1e-4)
        elif key != "disparity":
            assert got[key] == ref[key], key
    if case == "golden":
        assert got["xsobel_vs_golden"] == {"mismatches": 0, "pass": True}
        assert got["all_pass"]
    left = np.load(os.path.join(FIXTURES, "rect_left.npy"))
    right = np.load(os.path.join(FIXTURES, "rect_right.npy"))
    if case == "crop":
        left, right = left[CROP], right[CROP]
    conv = _hold_disparity(arrays["disparity"], left, right)
    # tpuslam's rounds converge on the crop and not on the whole pair
    assert conv == (case == "crop")
    if conv:
        assert got["disparity"] == ref["disparity"]


@pytest.mark.parametrize("case", ["golden", "crop"])
def test_kernel_test_dumps(kernel_tests, case):
    """The harness's dumps: the integer warp, the eigenvalue image equal
    to tpuslam's, the float warp within one level (1e-4 before the
    truncation), the depth image where the disparity agrees."""
    _, _, arrays, root = kernel_tests[case]
    got, ref = root / "got", root / "ref"
    assert sorted(os.listdir(got)) == sorted(os.listdir(ref))
    for name in ("rect_l_000000.png", "eig_000000.png"):
        np.testing.assert_array_equal(_decoded(got / name),
                                      _decoded(ref / name))
    d = np.abs(_decoded(got / "rect_r_000000.png").astype(int) -
               _decoded(ref / "rect_r_000000.png"))
    assert d.max() <= 1
    from tpuslam_torch.runtime.dumps import save_depth_image
    save_depth_image(str(root / "want"), 0, _reference_disparity(
        *_pair(case))[0])
    np.testing.assert_array_equal(_decoded(got / "depth_000000.png"),
                                  _decoded(root / "want" /
                                           "depth_000000.png"))


def _pair(case):
    left = np.load(os.path.join(FIXTURES, "rect_left.npy"))
    right = np.load(os.path.join(FIXTURES, "rect_right.npy"))
    return (left[CROP], right[CROP]) if case == "crop" else (left, right)


# ---------------------------------------------- patterns, IMU, frame timing
@pytest.mark.parametrize("pattern", PATTERNS)
def test_patterns_equal(pattern):
    from tpuslam.io import patterns as J
    from tpuslam_torch.io import patterns as T
    for kw in (dict(), dict(height=37, width=300, frame_index=261)):
        np.testing.assert_array_equal(T.generate_pattern(pattern, **kw),
                                      J.generate_pattern(pattern, **kw))
    with pytest.raises(ValueError):
        T.generate_pattern(9)


def test_imu_and_frame_meas_equal():
    """The synthetic LSM9DS1 reads, the 9-DoF self-test's printout and
    result, and FrameMeas's statistics equal tpuslam's."""
    from tpuslam.io import imu as JI
    from tpuslam.runtime import frame_meas as JF
    from tpuslam_torch.io import imu as TI
    from tpuslam_torch.runtime import frame_meas as TF
    out = {}
    for mod in (JI, TI):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            found = mod.hw_test_9dof()
        lines = []
        absent = mod.hw_test_9dof(
            [mod.SyntheticLsm9ds1(present=False), mod.SyntheticLsm9ds1()],
            log=lines.append)
        dev = mod.SyntheticLsm9ds1(seed=5)
        s = [dev.read_sample() for _ in range(3)]
        out[mod] = (found, buf.getvalue(), absent, lines,
                    [(x.stamp, x.accel_g.tolist(), x.gyro_dps.tolist(),
                      x.mag_gauss.tolist()) for x in s])
    assert out[TI] == out[JI]
    assert out[TI][2] == [False, True]
    stamps = [0.0, 0.0331, 0.0669, 0.1, 0.1338, 0.1662]
    stats = {}
    for mod in (JF, TF):
        fm = mod.FrameMeas()
        fm.trigger()
        for s in stamps:
            fm.feed(stamp=s, height=376, width=1241)
        stats[mod] = (fm.stats(), fm.complete, fm.v_period, fm.h_period)
    assert stats[TF] == stats[JF]


@pytest.mark.parametrize("test", ["9dof", "patterns", "timing"])
def test_hw_test_main(monkeypatch, capsys, test):
    """Each self-test exits 0 on the CPU and prints tpuslam's lines (the
    round-trip time aside); the patterns test at 64x96 (the card runs
    480x640), every output finite and of the pattern's shape."""
    from tpuslam_torch.cli import hw_test as T
    monkeypatch.setattr(T, "PATTERN_SIZE", (64, 96))
    outputs = {}
    if test == "patterns":
        assert T.test_patterns(device="cpu", outputs=outputs) == 0
        assert sorted(outputs) == list(PATTERNS)
        for outs in outputs.values():
            assert [o.shape for o in outs] == [(64, 96)] * 3
            assert [o.dtype for o in outs] == [np.int16, np.float32,
                                               np.uint8]
    assert T.main([test, "-device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    if test == "patterns":
        assert lines[-5:] == [
            f"pattern {p}: outputs [(64, 96), (64, 96), (64, 96)] "
            f"finite=True" for p in PATTERNS]
    elif test == "timing":
        assert lines[0].startswith("device round-trip: ")
        assert lines[1] == ("frame_meas: v_period=33.33 ms "
                            "h_period=69.44 us fps=30.00 jitter=0.000 ms")
    else:
        from tpuslam.cli import hw_test as J
        assert J.main(["9dof"]) == 0
        assert capsys.readouterr().out.splitlines() == lines


# -------------------------------------------------------------- frontend_one
# -------------------------------------------------------------- frontend_one
@pytest.mark.parametrize("block", [3, 5])
def test_response_and_blur_dispatchers_on_the_cpu(block):
    """gftt_response_auto and orb_blur_auto on a CPU tensor run the plain
    versions, counted, at any block size; the card's half (the kernels,
    and a refused block raising) is in test_torch_cuda.py."""
    import torch
    from tpuslam_torch.kernels import _cuda, gftt as G, orb as O
    img = torch.as_tensor(_pair("crop")[0])[None].contiguous()
    _cuda.reset_counters()
    eig, blur = G.gftt_response_auto(img, block), O.orb_blur_auto(img)
    assert _cuda.PLAIN_CALLS["gftt"] == _cuda.PLAIN_CALLS["orb_blur"] == 1
    assert sum(_cuda.LAUNCHES.values()) == 0
    assert torch.equal(eig, G.gftt_response(img, block))
    assert torch.equal(blur, O.orb_blur(img))


@pytest.fixture(scope="module")
def jax_frontend():
    from tpuslam.dist.mesh import frontend_one
    return jax.jit(frontend_one)


@pytest.mark.parametrize("case", ["fixture"] + [f"pattern{p}"
                                                for p in PATTERNS])
def test_frontend_one(jax_frontend, case):
    """frontend_one on the CPU against tpuslam's at 64x96: the disparity
    as set out above (flat patterns hold all-invalid rows), the response
    to the GFTT tests' tolerance, the blur within one level; the plain
    versions counted, nothing launched."""
    from tpuslam_torch.dist.mesh import frontend_one
    from tpuslam_torch.io.patterns import generate_pattern
    from tpuslam_torch.kernels import _cuda
    if case == "fixture":
        left, right = _pair("crop")
    else:
        left = right = generate_pattern(int(case[-1]), 64, 96, 7)
    _cuda.reset_counters()
    disp, eig, blur = (o.numpy() for o in frontend_one(left, right,
                                                       device="cpu"))
    assert _cuda.PLAIN_CALLS["stereo_bm"] == _cuda.PLAIN_CALLS["gftt"] == \
        _cuda.PLAIN_CALLS["orb_blur"] == 1
    assert sum(_cuda.LAUNCHES.values()) == 0
    jd, je, jb = (np.asarray(o) for o in jax_frontend(left, right))
    assert disp.dtype == jd.dtype and eig.dtype == je.dtype and \
        blur.dtype == jb.dtype
    assert _hold_disparity(disp, left, right)
    np.testing.assert_array_equal(disp, jd)
    np.testing.assert_allclose(eig, je, rtol=2e-6, atol=1e-7)
    assert np.abs(blur.astype(int) - jb).max() <= 1


# -------------------------------------------------------------- capture app
def test_stereo_capture_patterns(tmp_path):
    """-source pattern writes tpuslam's images and timestamps."""
    from tpuslam.cli import stereo_capture as J
    from tpuslam_torch.cli import stereo_capture as T
    got = T.run(str(tmp_path / "got"), n_frames=3, source="pattern",
                pattern=3, quiet=True, device="cpu")
    ref = J.run(str(tmp_path / "ref"), n_frames=3, source="pattern",
                pattern=3, quiet=True)
    assert open(os.path.join(got, "timestamp.txt")).read() == \
        open(os.path.join(ref, "timestamp.txt")).read()
    for sub in ("image_0", "image_1"):
        names = sorted(os.listdir(os.path.join(ref, sub)))
        assert sorted(os.listdir(os.path.join(got, sub))) == names
        for n in names:
            np.testing.assert_array_equal(
                _decoded(os.path.join(got, sub, n)),
                _decoded(os.path.join(ref, sub, n)))


def test_stereo_capture_synthetic_frontend(tmp_path):
    """-source synthetic -frontend over 2 frames: the KITTI layout of
    640x480 frames, and for every frame the seven dump kinds of the front
    end's Frame (K1, K5, K2 and K3's plain versions, and the response
    again for the eigenvalue dump), with keypoints."""
    from tpuslam_torch.cli import stereo_capture as T
    from tpuslam_torch.kernels import _cuda
    _cuda.reset_counters()
    d = T.run(str(tmp_path), n_frames=2, source="synthetic",
              frontend=True, quiet=True, device="cpu")
    assert sorted(os.listdir(d)) == ["calib.txt", "dumps", "image_0",
                                     "image_1", "poses.txt", "times.txt"]
    for sub in ("image_0", "image_1"):
        assert sorted(os.listdir(os.path.join(d, sub))) == \
            ["000000.png", "000001.png"]
        assert _decoded(os.path.join(d, sub, "000001.png")).shape == \
            (480, 640)
    dumps = sorted(os.listdir(os.path.join(d, "dumps")))
    kinds = ("rect_l", "rect_r", "kpts", "depth", "eig", "kpts2d",
             "kpts3d", "desc")
    assert len(dumps) == 2 * len(kinds)
    for i in range(2):
        for k in kinds:
            ext = "csv" if k in ("kpts2d", "kpts3d", "desc") else "png"
            assert f"{k}_{i:06d}.{ext}" in dumps
        rows = open(os.path.join(d, "dumps", f"kpts2d_{i:06d}.csv")).read()
        assert rows.count("\n") > 0
    assert _cuda.PLAIN_CALLS["stereo_bm"] == _cuda.PLAIN_CALLS["lr_check"] \
        == _cuda.PLAIN_CALLS["orb"] == 2
    assert _cuda.PLAIN_CALLS["gftt"] == 4
    assert sum(_cuda.LAUNCHES.values()) == 0


# ------------------------------------------------------------ photo texture
@pytest.fixture(scope="module")
def photo():
    return np.load(os.path.join(FIXTURES, "rect_left.npy"))


def test_photo_pyramid_equal(photo):
    from tpuslam.io import synthetic as J
    from tpuslam_torch.io import synthetic as T
    ref = J.photo_pyramid(photo)
    got = T.photo_pyramid(photo, device="cpu")
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_photo_mirror_is_floor_mod():
    """The mirror tiling's modulo is jnp.mod's (floor) for negative and
    boundary coordinates."""
    from tpuslam_torch.io import synthetic as T
    u = np.array([-0.5, -10.0, -1e-8, 0.0, 3.0, -78.0, -79.25, 1000.25,
                  39.0, 39.5, 77.99], np.float32)
    period = 78.0
    m = np.asarray(jnp.mod(jnp.asarray(u), period))
    want = np.where(m <= 39, m, period - m)
    np.testing.assert_array_equal(T._mirror(torch.as_tensor(u), 40).numpy(),
                                  want)


def test_photo_render_matches(photo):
    from tpuslam.io import synthetic as J
    from tpuslam_torch.io import synthetic as T
    poses = T.forward_trajectory(30, 1.4, 0.003)
    jw = J.BoxWorld(poses, seed=11, photo=photo)
    tw = T.BoxWorld(poses, seed=11, photo=photo)
    for p in (poses[0], poses[17], poses[29]):
        ref = jw.render(p, 180.0, 79.5, 59.5, 120, 160)
        got = tw.render(p, 180.0, 79.5, 59.5, 120, 160, device="cpu")
        _grey_levels_close(got.numpy(), ref)


def test_photo_sequence_matches_written_files(tmp_path, photo):
    """make_sequence and write_sequence with texture_photo against
    tpuslam's make_sequence(texture_photo=...) files."""
    from tpuslam.io import synthetic as J
    from tpuslam_torch.io import synthetic as T
    kw = dict(n_frames=2, width=96, height=64, f=80.0, baseline=0.54,
              speed=1.4, yaw_rate=0.003, seed=11)
    J.make_sequence(str(tmp_path / "ref"), texture_photo=photo, **kw)
    T.write_sequence(str(tmp_path / "got"), texture_photo=photo,
                     device="cpu", **kw)
    left, right, _, _ = T.make_sequence(texture_photo=photo, device="cpu",
                                        **kw)
    for sub, imgs in (("image_0", left), ("image_1", right)):
        for i in range(2):
            name = f"{i:06d}.png"
            ref = _decoded(tmp_path / "ref" / sub / name)
            _grey_levels_close(imgs[i].numpy(), ref)
            np.testing.assert_array_equal(
                _decoded(tmp_path / "got" / sub / name), imgs[i].numpy())
    plain, _, _, _ = T.make_sequence(device="cpu", **kw)
    assert not torch.equal(plain, left)
    for name in ("calib.txt", "times.txt", "poses.txt"):
        assert open(tmp_path / "got" / name).read() == \
            open(tmp_path / "ref" / name).read()
