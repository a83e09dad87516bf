"""Kernels K1-K6 against their plain PyTorch versions, on the card.

Runs only where a CUDA device and nvcc are present (skipped elsewhere),
and imports neither JAX nor tpuslam, so on a GPU machine without JAX it
runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

K1-K5 and each phase of the K1 phase harness must equal their plain
versions exactly (bit for bit for the f32 GFTT response), also at the
edge cases of K2's tiles and K5's row blocks; K6, the LM refine, agrees
with its plain version to f32 reduction order: rvec 1e-5, tvec 1e-4 and
the same inliers at 2 px (the JAX suite's Pallas-vs-XLA tolerance,
tests/test_pnp.py:127-133).  The
image inputs are the repository's real 640x480 stereo fixture, cropped to
the bench's 376 rows.  Two end-to-end tests check through the launch
counters that the default configuration's chunk step, and a Mapper run
whose loop closure fires, launch the kernels and no plain version; a
third does so for the batch app (the per-frame path), and the speckle
filter on the card is held to the CPU bit for bit.  Configurations outside
K1's packed kernel run in its wide kernel (staged, or its global variant
at a radius whose tile exceeds shared memory) and equal its plain twin; GFTT
outside K2's block size runs the plain version on the card and equals the
CPU; run_ingest on the card equals run_staged on the same written frames.
The depth engines outside the kernels: SGBM on the card equals the CPU
bit for bit, LK agrees with it, the integer rectification warp equals
it, and the realtime app on the card gives the batch app's poses.  The
tool apps: frontend_one and the kernel A/B harness on the card equal the
CPU and count their launches; the photo-textured renderer agrees with
the CPU to a grey level.
"""

import os

import numpy as np
import pytest
import torch

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

pytestmark = pytest.mark.cuda


@pytest.fixture()
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    left = np.load(os.path.join(FIXTURES, "rect_left.npy"))[:376]
    right = np.load(os.path.join(FIXTURES, "rect_right.npy"))[:376]
    lb = torch.as_tensor(np.stack([left, right])).cuda()
    rb = torch.as_tensor(np.stack([right, left])).cuda()
    return lb.contiguous(), rb.contiguous()


def _slice_cfg():
    from tpuslam_torch.config import SlamConfig, StereoBMConfig, PnPConfig
    return SlamConfig().replace(bm=StereoBMConfig(disp12_max_diff=-1),
                                pnp=PnPConfig(refine_iterations=0))


def _sawtooth_pair(h=101, w=333):
    """A rising sawtooth (8 grey levels per pixel, period 32) on the left
    and the falling one on the right: at prefilter_cap 63 the prefiltered
    left sits at 126 and the right at 0 almost everywhere, so every cost is
    near 126 * (2r+1)^2.  Neither side is a whole number of K1's tiles."""
    ramp = (np.arange(w) % 32 * 8).astype(np.uint8)
    left = np.broadcast_to(ramp, (2, h, w))
    right = np.broadcast_to(248 - ramp, (2, h, w))
    return (torch.as_tensor(np.ascontiguousarray(left)).cuda(),
            torch.as_tensor(np.ascontiguousarray(right)).cuda())


# K1's packed kernel at the sawtooth pair: cap 63 at the main path's block,
# and the largest cost its 16-bit lanes admit (2 * 34 * 31**2 = 65348)
PACKED_SAWTOOTH = {"wide_minsad": dict(prefilter_cap=63, block_size=21),
                   "packed_limit": dict(prefilter_cap=34, block_size=31)}


@pytest.mark.parametrize("case", ["fixture"] + list(PACKED_SAWTOOTH))
def test_stereo_bm_kernel(pair, case):
    """K1 (its packed kernel) equals its plain twin: on the fixture in the
    slice's settings, and on the sawtooth pair, whose min-SAD lies between
    32768 and 65535 and which K1 writes as int32: at cap 63, block 21, and
    at cap 34, block 31, where the costs come near the lanes' limit, so a
    carry across the 16-bit lanes would show."""
    from tpuslam_torch.config import StereoBMConfig
    from tpuslam_torch.kernels import stereo_bm as T
    if case == "fixture":
        args, cfg = pair, _slice_cfg().bm
    else:
        args = _sawtooth_pair()
        cfg = StereoBMConfig(**PACKED_SAWTOOTH[case])
    assert T.k1_packed_refusal(cfg) is None
    assert T.stereo_bm_packed_shape(cfg)["blocks_per_sm"] >= 2
    kd, ks = T.stereo_bm_cuda(*args, cfg)
    pd, ps = T.stereo_bm_plain(*args, cfg)
    torch.cuda.synchronize()
    assert ks.dtype == ps.dtype == torch.int32
    assert torch.equal(kd, pd)
    assert torch.equal(ks, ps)
    if case == "fixture":
        assert (pd >= 0).float().mean() > 0.2
    else:
        assert 32767 < int(ps.max()) <= 65535


# crops of the pair for the harness (rows, columns): a multiple of no tile,
# and shorter than one tile of 64 rows
PHASE_CROPS = {True: (373, 629), "short": (40, 75)}


@pytest.mark.parametrize("crop", [False, True, "short"])
@pytest.mark.parametrize("phase", ["prefilter", "vbox", "boxes", "winner",
                                   "sad", "uniq", "full"])
def test_stereo_bm_phase_kernel(pair, phase, crop):
    """The K1 phase harness: each cut of K1 equals its plain twin bit for
    bit, the full cut equals K1, each cut runs at K1's occupancy, and a
    harness launch counts only as itself; also on a crop of 373x629, not
    a whole number of K1's 32-column tiles, whose last row of tiles ends
    inside the image (rows outside staged as zeros, the texture's mask),
    and on a 40x75 crop, shorter than one tile."""
    from tpuslam_torch.config import StereoBMConfig
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.kernels import stereo_bm as T
    cfg = StereoBMConfig()
    if crop:
        h, w = PHASE_CROPS[crop]
        pair = tuple(t[:, :h, :w].contiguous() for t in pair)
    _cuda.reset_counters()
    got = T.stereo_bm_phase_cuda(*pair, cfg, phase)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["stereo_bm_phase"] == 1
    assert not any(_cuda.LAUNCHES[k] for k in _cuda.KERNELS)
    want = T.stereo_bm_phase_plain(*pair, cfg, phase)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if phase == "full":
        k1 = T.stereo_bm_cuda(*pair, cfg)
        assert torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1])
    if phase != "prefilter":      # every cut at K1's blocks per SM
        assert T.stereo_bm_phase_occupancy(phase)[2] == \
            T.stereo_bm_phase_occupancy("full")[2] > 0


def test_gftt_kernel(pair):
    from tpuslam_torch.kernels import gftt as T
    ke, kd = T.gftt_response_dil_cuda(pair[0])
    pe, pd = T.gftt_response_dil_plain(pair[0])
    torch.cuda.synchronize()
    assert torch.equal(ke.view(torch.int32), pe.view(torch.int32))
    assert torch.equal(kd, pd)


def _gftt_case(pair, case):
    """The (B, H, W) u8 image of one K2 edge case."""
    img = pair[0]
    if case == "crop":                   # not a whole number of tiles
        return img[:, :101, :333].contiguous()
    if case == "odd_width":              # word-loaded tiles at every
        return img[:, :, :637].contiguous()  # row alignment
    if case in ("rows2", "rows3"):       # reflect-101 across the image
        return img[:, 200:200 + int(case[-1])].contiguous()
    if case in ("cols2", "cols3"):
        return img[:, :, 300:300 + int(case[-1])].contiguous()
    if case == "b1":
        return img[:1].contiguous()
    if case == "uniform":
        return torch.full_like(img, 77)
    if case == "checkerboard":           # saturated 0/255
        y = torch.arange(img.shape[1], device=img.device)[:, None]
        x = torch.arange(img.shape[2], device=img.device)[None, :]
        board = ((x + y) % 2 * 255).to(torch.uint8)
        return board.expand(img.shape).contiguous()
    raise ValueError(case)


@pytest.mark.parametrize("case", ["crop", "odd_width", "rows2", "rows3",
                                  "cols2", "cols3", "b1", "uniform",
                                  "checkerboard"])
def test_gftt_kernel_edges(pair, case):
    """K2 equals its plain twin (eig bit for bit, the dilation exactly) in
    one launch: on a crop that is not a whole number of tiles, on an odd
    width whose rows start at every word alignment, on 2 and 3 rows and
    columns (reflect-101 of the pixels and of the products reaches across
    the whole image), on one frame, on a uniform image and on a saturated
    checkerboard."""
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.kernels import gftt as T
    img = _gftt_case(pair, case)
    _cuda.reset_counters()
    ke, kd = T.gftt_response_dil_cuda(img)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["gftt"] == 1
    pe, pd = T.gftt_response_dil_plain(img)
    assert torch.equal(ke.view(torch.int32), pe.view(torch.int32))
    assert torch.equal(kd, pd)


def _random_keypoints(B, K, H, W, seed):
    """Keypoints anywhere in (and a pixel past) the image, 80 % valid."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(-1.0, W, (B, K)),
                   rng.uniform(-1.0, H, (B, K))], axis=-1)
    return (torch.as_tensor(xy.astype(np.float32)).cuda(),
            torch.as_tensor(rng.uniform(size=(B, K)) < 0.8).cuda())


def _orb_case(pair, case):
    """(image, keypoints, valid) of one K3 case."""
    img = pair[0]
    B, H, W = img.shape
    if case == "fixture":
        from tpuslam_torch.vo.fused import detect_keypoints
        kp, valid, n_k = detect_keypoints(img.cpu(), _slice_cfg())
        assert int(n_k.min()) > 100
        return img, kp[..., :2].contiguous().cuda(), valid.cuda()
    if case == "crop":                  # not a whole number of blur tiles
        img = img[:, :101, :333].contiguous()
        return (img,) + _random_keypoints(B, 300, 101, 333, 1)
    if case == "odd_width":             # word-loaded tiles at every
        img = img[:, :, :637].contiguous()  # row alignment
        return (img,) + _random_keypoints(B, 300, H, 637, 6)
    if case == "four_rows":             # reflect-101 across the image
        img = img[:, 100:104].contiguous()
        return (img,) + _random_keypoints(B, 200, 4, W, 2)
    if case == "corners":               # samples outside read 0
        c = [(0, 0), (W - 1, 0), (0, H - 1), (W - 1, H - 1),
             (-0.4, H - 0.6), (W - 0.5, 0.5)]
        kp = torch.tensor([c] * B, dtype=torch.float32).cuda()
        return img, kp, torch.ones(kp.shape[:2], dtype=torch.bool).cuda()
    if case == "all_invalid":
        kp, _ = _random_keypoints(B, 64, H, W, 3)
        return img, kp, torch.zeros(kp.shape[:2], dtype=torch.bool).cuda()
    if case == "k0":
        return (img,) + _random_keypoints(B, 0, H, W, 4)
    if case == "odd_count":             # B x K = 3 x 13, not a multiple
        img = torch.cat([img, img[:1]]).contiguous()   # of 8 per block
        return (img,) + _random_keypoints(3, 13, H, W, 5)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["fixture", "crop", "odd_width",
                                  "four_rows", "corners", "all_invalid",
                                  "k0", "odd_count"])
def test_orb_kernel(pair, case):
    """K3 equals its plain twin bit for bit, and each of its halves as a
    tool launcher equals its plain half: on the fixture's keypoints, on a
    crop that is not a whole number of blur tiles, on a width whose rows
    start at every word alignment (the blur's word-loaded staging), on 4
    rows (reflect-101 reaches across the image), with keypoints at the
    corners (samples outside the image read 0), with every row invalid,
    with no keypoints and with a keypoint count that fills no whole
    block."""
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.kernels import orb as T
    img, kp, valid = _orb_case(pair, case)
    _cuda.reset_counters()
    k = T.orb_descriptors_cuda(img, kp, valid)
    kb = T.orb_blur_cuda(img)
    pb = T.orb_blur(img)
    kt = T.orb_tests_cuda(pb, kp, valid)
    p = T.orb_descriptors_plain(img, kp, valid)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert torch.equal(kb, pb)
    assert torch.equal(kt, T.descriptors_from_blurred(pb, kp, valid))
    assert not k[~valid].any()
    assert (_cuda.LAUNCHES["orb"], _cuda.LAUNCHES["orb_blur"],
            _cuda.LAUNCHES["orb_tests"]) == (1, 1, 1)
    if case in ("fixture", "crop", "odd_width", "corners"):
        assert k.any()


@pytest.mark.parametrize("n", [1, 31, 513, 1536, 1537, 5000])
def test_median_kernel(pair, n):
    """K4 equals its plain twin exactly with ties, +inf, count 0, count 1
    and a sparse row, at N below one key per thread, past each number of
    register-held keys per thread and past the register-held keys (N >
    4096, the keys re-read from memory)."""
    from tpuslam_torch.vo import fused as F
    rng = np.random.default_rng(7)
    a = np.abs(rng.normal(0, 10, (6, n))).astype(np.float32)
    b = np.abs(rng.normal(0, 2, (6, n))).astype(np.float32)
    a[1] = np.round(a[1])                      # ties
    a[2, ::3] = np.inf                         # +inf
    m = rng.uniform(size=(6, n)) < 0.5
    m[3] = False                               # count 0
    m[4] = False
    m[4, n // 3] = True                        # count 1
    m[5] = rng.uniform(size=n) < 0.002
    a, b, m = (torch.as_tensor(v).cuda() for v in (a, b, m))
    k = F.masked_median2_cuda(a, b, m)
    p = F.masked_median2_plain(a, b, m)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(k[2].long(), p[2])


def test_lr_check_kernel(pair):
    from tpuslam_torch.config import StereoBMConfig
    from tpuslam_torch.kernels import stereo_bm as T
    cfg = StereoBMConfig()
    disp, minsad = T.stereo_bm_cuda(*pair, cfg)
    assert minsad.dtype == torch.int32
    k = T.lr_check_cuda(disp, minsad, cfg)
    p = T.lr_check_plain(disp, minsad, cfg)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert 0 < int((k != disp).sum()) < 0.05 * disp.numel()


# (min_disparity, num_disparities, disp12_max_diff) of the K5 edge cases
_LR_CFGS = [(0, 64, 1), (-8, 16, 3), (5, 64, 0), (5, 16, 1), (-8, 64, 0)]


@pytest.mark.parametrize("cfg", range(len(_LR_CFGS)))
@pytest.mark.parametrize("width", [1, 65, 637, 1241, 2000])
def test_lr_check_kernel_random(pair, width, cfg):
    """K5 equals its plain twin on random int16 disparities (~20 %
    `filtered`, a few outside the disparity range, which take the general
    path) and int32 min-SAD below 2^19, at widths from 1 to 2000 (inside
    one pass of 416 columns per row and across up to 5), with 3 x 5 = 15 and
    2 x 5 = 10 rows (neither a whole number of K5's blocks of 4 rows),
    nonzero min_disparity, 16 and 64 disparities and three
    disp12_max_diff; the 2 frames are a view that starts a frame in."""
    from tpuslam_torch.config import StereoBMConfig
    from tpuslam_torch.kernels import stereo_bm as T
    mindisp, ndisp, max_diff = _LR_CFGS[cfg]
    rng = np.random.default_rng(width * 10 + cfg)
    lo, hi = mindisp * 16, (mindisp + ndisp) * 16
    shape = (3, 5, width)
    disp = rng.integers(lo - 32, hi + 32, shape).astype(np.int16)
    disp[rng.uniform(size=shape) < 0.2] = (mindisp - 1) * 16
    minsad = rng.integers(0, 2 ** 19, shape).astype(np.int32)
    bm = StereoBMConfig(min_disparity=mindisp, num_disparities=ndisp,
                        disp12_max_diff=max_diff)
    d, m = torch.as_tensor(disp).cuda(), torch.as_tensor(minsad).cuda()
    for dd, mm in ((d, m), (d[1:], m[1:])):
        k = T.lr_check_cuda(dd, mm, bm)
        p = T.lr_check_plain(dd, mm, bm)
        torch.cuda.synchronize()
        assert torch.equal(k, p)
    if width > 100:
        assert (p != d[1:]).any()


_LM_K = np.array([[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157],
                  [0.0, 0.0, 1.0]])
# N per case: the capacity, and around K6's 384 point threads with 4
# points each in registers: below one point per thread, not a multiple of
# 384, and past the register-resident points (the strided tail)
_LM_N = {"perturbed": 300, "zero_rvec": 300, "capacity": 1536, "n40": 40,
         "n1000": 1000, "n2000": 2000}


@pytest.mark.parametrize("case", list(_LM_N))
def test_lm_refine_kernel(pair, case):
    from tpuslam_torch.io.synthetic import pnp_scene
    from tpuslam_torch.kernels import pnp as T
    rng = np.random.default_rng(11)
    n = _LM_N[case]
    args, _, _ = pnp_scene(rng, n, _LM_K,
                           np.zeros(3) if case == "zero_rvec" else None)
    rk, tk, ek = T.refine_lm_errors_cuda(*args)
    rp, tp, ep = T.refine_lm_with_errors(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(rk, rp, rtol=0, atol=1e-5)
    torch.testing.assert_close(tk, tp, rtol=0, atol=1e-4)
    assert torch.equal(ek <= 2.0, ep <= 2.0)
    assert int((ek <= 2.0).sum()) > 0.6 * n


def test_lm_refine_deterministic(pair):
    """Two launches on the same inputs give the same bits: K6's
    reductions have a fixed order and no atomics."""
    from tpuslam_torch.io.synthetic import pnp_scene
    from tpuslam_torch.kernels import pnp as T
    args, _, _ = pnp_scene(np.random.default_rng(5), 1536, _LM_K)
    r1, t1, e1 = T.refine_lm_errors_cuda(*args)
    r2, t2, e2 = T.refine_lm_errors_cuda(*args)
    torch.cuda.synchronize()
    for a, b in ((r1, r2), (t1, t2), (e1, e2)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_dispatch_counts_kernels_not_plain(pair):
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.vo.fused import make_frontend_fn, FusedShapes
    from tpuslam_torch.io.synthetic import sequence_camera
    _cuda.reset_counters()
    fe = make_frontend_fn(sequence_camera(640, 376, 500.0, 0.54),
                          _slice_cfg(), FusedShapes(chunk=2), device="cuda")
    out = fe(*pair)
    torch.cuda.synchronize()
    assert all(_cuda.LAUNCHES[k] == 1 for k in ("stereo_bm", "gftt", "orb"))
    assert not any(_cuda.PLAIN_CALLS.values())
    assert int(out["n_kpts"].min()) > 100


def test_mapper_loop_closure_runs_kernels():
    """FastSlamPipeline.run_staged with a Mapper on the card, async loop
    closure and the device dictionary, in test_torch_mapping.py's
    configuration (12 frames, a short-term memory of 2 full nodes, a low
    loop threshold), so that loop closure fires: its registration launches
    K6 beyond the VO step's once per frame, and no plain version runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.config import SlamConfig, MapperConfig
    from tpuslam_torch.io.synthetic import make_sequence, sequence_camera
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.mapping.mapper import Mapper
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    n = 12
    lefts, rights, stamps, _ = make_sequence(n, 320, 240, 250.0, 0.54, 0.4,
                                             0.002, seed=3)
    cfg = SlamConfig().replace(mapper=MapperConfig(
        map_update=2, max_stm_size=2, loop_thr=0.05))
    cam = sequence_camera(320, 240, 250.0, 0.54)
    mapper = Mapper(cam, cfg.mapper, cfg.matching, cfg.pnp)
    mapper.async_lc = True
    pipe = FastSlamPipeline(cam, cfg, chunk=6, capacity=384)
    items = [dict(left=lefts[i], right=rights[i], stamp=stamps[i])
             for i in range(n)]
    staged = pipe.stage_chunks(items)
    _cuda.reset_counters()
    infos = pipe.run_staged(staged, items, mapper=mapper, mapper_async=True)
    torch.cuda.synchronize()
    assert not any(i.lost for i in infos)
    assert mapper.loop_closures
    assert len(mapper.nodes) == n and mapper.vwd._count > 0
    assert all(_cuda.LAUNCHES[k] > 0 for k in _cuda.KERNELS)
    assert _cuda.LAUNCHES["lm_refine"] >= n + len(mapper.loop_closures)
    assert not any(_cuda.PLAIN_CALLS.values())


def test_default_config_chunk_runs_all_kernels():
    """The fused chunk step in SlamConfig() on the card: K1-K3 and K5 once
    per chunk, K4 and K6 once per frame, no tool launcher, K7 (the pose
    graph's) never, no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.config import SlamConfig
    from tpuslam_torch.io.synthetic import make_sequence, sequence_camera
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.vo.fused import make_fused_chunk_fn, FusedShapes
    B = 4
    lefts, rights, _, _ = make_sequence(B, 640, 376, 500.0, 0.54, 0.5,
                                        0.004, seed=5)
    init, step, _ = make_fused_chunk_fn(
        sequence_camera(640, 376, 500.0, 0.54), SlamConfig(),
        FusedShapes(chunk=B, capacity=1024))
    _cuda.reset_counters()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dts = torch.full((B,), 0.1, device="cuda")
    dts[0] = 0.0
    _, outs, _ = step(init(), lefts, rights, dts,
                      torch.ones(B, dtype=torch.bool, device="cuda"),
                      torch.rand((B, 300, 6), generator=gen, device="cuda"))
    torch.cuda.synchronize()
    assert not outs["lost"][1:].any()
    assert dict(_cuda.LAUNCHES) == dict(stereo_bm=1, gftt=1, orb=1,
                                        median=B, lr_check=1, lm_refine=B,
                                        stereo_bm_phase=0, orb_blur=0,
                                        orb_tests=0, thomas=0)
    assert not any(_cuda.PLAIN_CALLS.values())


@pytest.mark.parametrize("batch", [1, 30])
def test_speckle_card_equals_cpu(batch):
    """The speckle filter on the card equals the same function on the CPU,
    bit for bit, on StereoBM disparity of rendered 1241x376 frames: one
    frame (speckle_filter) and a 30-frame batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.config import StereoBMConfig
    from tpuslam_torch.io.synthetic import make_sequence
    from tpuslam_torch.kernels import stereo_bm as BM
    lefts, rights, _, _ = make_sequence(batch, 1241, 376, 718.856, 0.54,
                                        1.4, 0.003, seed=11)
    bm = StereoBMConfig()
    disp = BM.stereo_bm_lr(lefts, rights, bm)
    args = (bm.speckle_window_size, bm.speckle_range, -16)
    if batch == 1:
        got = BM.speckle_filter(disp[0], *args)
        want = BM.speckle_filter(disp[0].cpu(), *args)
    else:
        got = BM.speckle_filter_batch(disp, *args)
        want = BM.speckle_filter_batch(disp.cpu(), *args)
    assert got.is_cuda
    assert torch.equal(got.cpu(), want)
    assert int((got != disp[0 if batch == 1 else slice(None)]).sum()) > 0


def test_batch_app_runs_kernels_and_closes_a_loop(tmp_path):
    """The batch app (cli/slam_batch.run) on the card over a written
    320x240 out-and-back sequence: K1, K2, K3 and K5 once per frame, K6
    beyond the odometry's registrations (loop closure), K4 never, no plain
    version, a loop closed and no frame lost."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.cli.slam_batch import run
    from tpuslam_torch.config import SlamConfig, MapperConfig
    from tpuslam_torch.io.synthetic import out_and_back_trajectory, \
        write_sequence
    from tpuslam_torch.kernels import _cuda
    poses = out_and_back_trajectory(7, 0.45)
    seq = write_sequence(str(tmp_path), width=320, height=240, f=250.0,
                         poses=poses, seed=7)
    cfg = SlamConfig().replace(mapper=MapperConfig(map_update=2,
                                                   max_stm_size=3))
    _cuda.reset_counters()
    res = run(seq, cfg, quiet=True)
    torch.cuda.synchronize()
    n = len(poses)
    assert res["n_nodes"] == n and res["n_loop_closures"] >= 1
    assert all(_cuda.LAUNCHES[k] == n
               for k in ("stereo_bm", "lr_check", "gftt", "orb"))
    assert _cuda.LAUNCHES["median"] == 0
    assert _cuda.LAUNCHES["lm_refine"] >= n - 1 + res["n_loop_closures"]
    assert not any(_cuda.PLAIN_CALLS.values())
    assert np.isfinite(res["ate_m"]) and res["n_occupied_voxels"] > 0


# configurations outside K1's packed kernel, which K1 runs in its wide
# kernel (the reference's strip kernel takes each): StereoBMConfig keywords
K1_WIDE = {"ndisp1": dict(num_disparities=1),
           "ndisp32": dict(num_disparities=32),
           "ndisp80": dict(num_disparities=80),
           "ndisp128": dict(num_disparities=128, min_disparity=-5),
           "block33": dict(prefilter_cap=15, block_size=33),
           "block51": dict(prefilter_cap=31, block_size=51),
           "block20": dict(block_size=20),
           "block1": dict(block_size=1, uniqueness_ratio=0),
           "cost": dict(prefilter_cap=63, block_size=23),
           "sawtooth_cost": dict(prefilter_cap=63, block_size=25),
           "odd_crop": dict(num_disparities=16, block_size=9)}
# cases run on a crop of the pair (rows, columns): a multiple of no tile
K1_WIDE_CROPS = {"odd_crop": (37, 203)}


@pytest.mark.parametrize("case", list(K1_WIDE))
def test_k1_wide_kernel(pair, case):
    """K1 runs a configuration its packed kernel cannot take in its wide
    kernel: equal to its plain twin on the card, outputs and min-SAD (past
    uint16 on the sawtooth pair); and stereo_bm on the card, K1 and K5
    launched and no plain version, equals stereo_bm on the CPU."""
    from tpuslam_torch.config import StereoBMConfig
    from tpuslam_torch.kernels import _cuda, stereo_bm as T
    cfg = StereoBMConfig(**K1_WIDE[case])
    assert T.k1_packed_refusal(cfg) is not None
    args = _sawtooth_pair() if case == "sawtooth_cost" else pair
    if case in K1_WIDE_CROPS:
        h, w = K1_WIDE_CROPS[case]
        args = tuple(t[:, :h, :w].contiguous() for t in args)
    _cuda.reset_counters()
    kd, ks = T.stereo_bm_cuda(*args, cfg)
    pd, ps = T.stereo_bm_plain(*args, cfg)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ks, ps)
    if case == "sawtooth_cost":
        assert int(ps.max()) > 65535
    else:
        assert (pd >= 0).float().mean() > 0.05
    assert T.stereo_bm_wide_shape(cfg)["staged"] == 1
    _cuda.reset_counters()
    got = T.stereo_bm(*args, cfg)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["stereo_bm"] == 1 and _cuda.LAUNCHES["lr_check"] == 1
    assert not any(_cuda.PLAIN_CALLS.values())
    assert torch.equal(got.cpu(), T.stereo_bm(*(t.cpu() for t in args), cfg))


def test_k1_wide_global_kernel(pair):
    """A block whose staged tile exceeds the card's shared memory per
    block (321: r = 160) runs in the wide kernel's global variant, equal
    to the plain version."""
    from tpuslam_torch.config import StereoBMConfig
    from tpuslam_torch.kernels import stereo_bm as T
    cfg = StereoBMConfig(block_size=321)
    shape = T.stereo_bm_wide_shape(cfg)
    assert shape["staged"] == 0 and shape["blocks_per_sm"] > 0
    kd, ks = T.stereo_bm_cuda(*pair, cfg)
    pd, ps = T.stereo_bm_plain(*pair, cfg)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ks, ps)
    assert (pd >= 0).sum() > 0


# a configuration outside K2's envelope (tpuslam computes it on its XLA
# path): GFTT's block size
OUT_OF_ENVELOPE = {"gftt_block5": 5}


@pytest.mark.parametrize("case", list(OUT_OF_ENVELOPE))
def test_out_of_envelope_runs_plain_on_the_card(pair, case):
    """A configuration that K2 refuses runs the plain version on the
    card, counted in PLAIN_CALLS and never launched, and equals the same
    call on the CPU."""
    from tpuslam_torch.kernels import _cuda, gftt as G
    assert G.k2_refusal(OUT_OF_ENVELOPE[case]) is not None

    def run(img):
        return G.gftt_candidates(img, 0.01, OUT_OF_ENVELOPE[case], 4096)
    _cuda.reset_counters()
    got = run(pair[0])
    torch.cuda.synchronize()
    assert _cuda.PLAIN_CALLS["gftt"] == 1 and _cuda.LAUNCHES["gftt"] == 0
    for a, b in zip(got, run(pair[0].cpu())):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n_frames", [8, 9])
def test_run_ingest_equals_staged_on_the_card(tmp_path, n_frames):
    """run_ingest on the card (native decoder threads, pinned rotating
    buffers, uploads on a copy stream) over a written 320x240 directory in
    chunks of 3 -- whole chunks, the buffers' rotation, and a partial last
    chunk (8 frames) or none (9) -- equals run_staged on the same frames:
    the frames each chunk computes on, poses, inliers, lost flags and the
    Mapper's graph; every kernel of the path runs and no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.config import MapperConfig, SlamConfig
    from tpuslam_torch.io.dataset import StereoImageDataset
    from tpuslam_torch.io.synthetic import sequence_camera, write_sequence
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.mapping.mapper import Mapper
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    seq = write_sequence(str(tmp_path), n_frames=n_frames, width=320,
                         height=240, f=250.0, speed=0.4, yaw_rate=0.002,
                         seed=3)
    ds = StereoImageDataset(left_dir=os.path.join(seq, "image_0"),
                            right_dir=os.path.join(seq, "image_1"),
                            times_path=os.path.join(seq, "times.txt"))
    items = [ds[i] for i in range(len(ds))]
    cam = sequence_camera(320, 240, 250.0, 0.54)
    cfg = SlamConfig().replace(mapper=MapperConfig(map_update=3))
    pipe = FastSlamPipeline(cam, cfg, chunk=3, capacity=384)
    seen = []
    dispatch = pipe.dispatch

    def recording(lb, rb, st, n):
        seen.append((torch.as_tensor(lb[:n]).cuda().clone(),
                     torch.as_tensor(rb[:n]).cuda().clone()))
        return dispatch(lb, rb, st, n)

    pipe.dispatch = recording

    def mapper():
        mp = Mapper(cam, cfg.mapper, cfg.matching, cfg.pnp)
        mp.async_lc = True
        return mp

    m_staged = mapper()
    staged = pipe.run_staged(pipe.stage_chunks(items), items,
                             mapper=m_staged, mapper_async=True)
    seen.clear()
    pipe.reset()
    m_ingest = mapper()
    _cuda.reset_counters()
    ingest = pipe.run_ingest(
        [os.path.join(ds.left_dir, n) for n in ds._left],
        [os.path.join(ds.right_dir, n) for n in ds._right],
        [it["stamp"] for it in items], mapper=m_ingest)
    torch.cuda.synchronize()
    assert all(_cuda.LAUNCHES[k] > 0 for k in _cuda.KERNELS)
    assert not any(_cuda.PLAIN_CALLS.values())
    for k, key in enumerate(("left", "right")):
        got = torch.cat([s[k] for s in seen]).cpu().numpy()
        np.testing.assert_array_equal(got, np.stack([it[key]
                                                     for it in items]))
    assert len(staged) == len(ingest) == n_frames
    for a, b in zip(staged, ingest):
        np.testing.assert_array_equal(a.pose, b.pose)
        assert a.num_inliers == b.num_inliers and a.lost == b.lost
    pa, la = m_staged.get_graph()
    pb, lb = m_ingest.get_graph()
    assert sorted(pa) == sorted(pb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])
    assert len(la) == len(lb)


# SGBM configurations held card against CPU: SGBMConfig() and min_d 0
SGBM_CASES = {"reference": dict(),
              "min0_uniq_lr": dict(min_disparity=0, num_disparities=64,
                                   uniqueness_ratio=10, disp12_max_diff=1)}


@pytest.mark.parametrize("case", list(SGBM_CASES))
def test_sgbm_card_equals_cpu(pair, case):
    """SGBM (plain PyTorch on both devices, integer throughout) on the card
    equals the CPU bit for bit, with and without the speckle pass; it
    launches none of K1-K6."""
    from tpuslam_torch.config import SGBMConfig
    from tpuslam_torch.kernels import _cuda, sgbm as S
    cfg = SGBMConfig(**SGBM_CASES[case])
    lb, rb = pair
    for speckle in (False, True):
        _cuda.reset_counters()
        card = S.sgbm(lb, rb, cfg, with_speckle=speckle, device="cuda")
        torch.cuda.synchronize()
        assert not any(_cuda.LAUNCHES.values())
        cpu = S.sgbm(lb.cpu(), rb.cpu(), cfg, with_speckle=speckle,
                     device="cpu")
        np.testing.assert_array_equal(card.cpu().numpy(), cpu.numpy())


def test_lk_card_against_cpu(pair):
    """LK stereo over 1536 points (the path's CAPACITY) on the card against
    the CPU: status equal on at least 99.5 % of the points, x within
    1e-3 px where both tracked."""
    from tpuslam_torch.kernels.lk_stereo import lk_stereo
    left, right = pair[0][0], pair[1][0]
    rng = np.random.default_rng(0)
    h, w = left.shape
    pts = np.stack([rng.uniform(0, w, 1536), rng.uniform(0, h, 1536)],
                   1).astype(np.float32)
    valid = np.arange(1536) < 1400
    cn, cs, ce = (t.cpu().numpy() for t in lk_stereo(left, right, pts, valid,
                                                     device="cuda"))
    pn, ps, pe = (t.numpy() for t in lk_stereo(left.cpu(), right.cpu(), pts,
                                               valid, device="cpu"))
    assert (cs == ps).mean() >= 0.995 and ps.sum() > 100
    both = cs & ps
    np.testing.assert_allclose(cn[both, 0], pn[both, 0], rtol=0, atol=1e-3)


def test_rectify_hw_warp_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.kernels.rectify import StereoRectifier
    left = np.load(os.path.join(FIXTURES, "raw_left.npy"))
    right = np.load(os.path.join(FIXTURES, "raw_right.npy"))
    card = StereoRectifier.from_reference_calib(device="cuda")(left, right)
    cpu = StereoRectifier.from_reference_calib(device="cpu")(left, right)
    for a, b in zip(card, cpu):
        assert a.is_cuda
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


def test_realtime_app_on_the_card_equals_batch(tmp_path):
    """The realtime app (pipelined, asynchronous loop closure) on the card
    over a written 6-frame 320x240 sequence: the batch app's VO poses,
    the same draws injected into both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.cli import slam_batch, slam_realtime
    from tpuslam_torch.config import SlamConfig, MapperConfig
    from tpuslam_torch.io.synthetic import write_sequence
    seq = write_sequence(str(tmp_path / "seq"), n_frames=6, width=320,
                         height=240, f=250.0, speed=0.4, yaw_rate=0.002,
                         seed=3)
    cfg = SlamConfig().replace(mapper=MapperConfig(map_update=2,
                                                   max_stm_size=2,
                                                   loop_thr=0.05))

    def draws(seed):
        return np.random.default_rng(seed).random((300, 6),
                                                  dtype=np.float32)
    b = slam_batch.run(seq, cfg, quiet=True, out_dir=str(tmp_path / "b"),
                       draws_fn=draws)
    r = slam_realtime.run(seq, cfg, quiet=True, out_dir=str(tmp_path / "r"),
                          draws_fn=draws)
    np.testing.assert_array_equal(r["vo_poses"], b["vo_poses"])
    assert r["n_loop_closures"] == b["n_loop_closures"]
    for nid in b["optimized"]:
        np.testing.assert_allclose(r["optimized"][nid], b["optimized"][nid],
                                   rtol=0, atol=1e-5)


# --- K7: the pose graph's block-Thomas solve --------------------------------

def _block_tridiagonal(n, m, seed=0):
    """A symmetric positive definite block-tridiagonal system (D (n,6,6),
    S (n-1,6,6), B (n,6,m)) made with numpy from `seed`: each diagonal
    block dominates its two neighbours."""
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 1, (n, 6, 6))
    D = A @ A.transpose(0, 2, 1) + 12 * np.eye(6)
    S = rng.normal(0, 0.5, (n - 1, 6, 6))
    B = rng.normal(0, 1, (n, 6, m))
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in (D, S, B)]


@pytest.mark.parametrize("n, m", [(2, 1), (2, 13), (61, 1), (61, 13),
                                  (1000, 1), (1000, 13), (61, 37),
                                  (61, 337), (61, 900), (60, 325),
                                  (4540, 13)])
def test_thomas_kernel(n, m):
    """K7 equals its plain version on the card bit for bit (the two take
    every sum in one order and divide and take square roots as IEEE
    does), and solves the system; 37 columns take two column warps of one
    thread block, 337 (28 Woodbury extras, about the per-frame graph's
    27) eleven, 900 three thread blocks, each with its own factor
    chain.  (60, 325) and (4540, 13) are the back end's shapes, a
    right-hand side beside Woodbury extras' unit block-columns
    (tools/thomas_probe.py random_system): mostly zeros, decaying through
    tiny and subnormal values along the chain (the plain version takes
    ~30 s at 4540 vertices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.optim import device as DEV
    from tpuslam_torch.tools.thomas_probe import random_system
    if (n, m) in ((60, 325), (4540, 13)):
        D, S, B, lam = random_system(n, m, seed=n * 100 + m)
        lam_f = float(lam)
    else:
        D, S, B = _block_tridiagonal(n, m, seed=n * 100 + m)
        lam, lam_f = torch.tensor(0.25, device="cuda"), 0.25
    _cuda.reset_counters()
    got = DEV.thomas_solve(D, S, B, lam)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["thomas"] == 1
    assert _cuda.PLAIN_CALLS["thomas"] == 0
    want = DEV._thomas_solve(D, S, B, lam)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    # the residual of the solve, in f64
    Dl = D.double() + lam_f * torch.eye(6, device="cuda",
                                        dtype=torch.float64)
    x = got.double()
    r = torch.einsum("nij,njc->nic", Dl, x) - B.double()
    r[1:] += torch.einsum("nij,njc->nic", S.double(), x[:-1])
    r[:-1] += torch.einsum("nji,njc->nic", S.double(), x[1:])
    assert float(r.abs().max()) < 1e-4 * float(B.abs().max()) * 10


def test_thomas_fast_division():
    """K7 divides by the fast path of IEEE division without its branch,
    where the operands' exponents keep every intermediate normal
    (csrc/thomas.cu div_fast), and elsewhere by fused multiply-adds with
    the subnormal rounding done by hand (div_small): on 2^24 random
    pairs, across and beyond that range, subnormals and zeros included,
    every quotient either takes equals IEEE division bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.tools.thomas_probe import divcheck
    pairs, within, differ, wide = divcheck(_cuda.library("thomas"))
    assert differ == 0 and wide == 0
    assert pairs // 4 < within < pairs


def _noisy_loop_80():
    """An 80-vertex noisy loop with one true loop closure and one gross
    one (tests/test_dist.py's): (poses, links)."""
    from tpuslam_torch.geometry.transform import from_rpy_xyz
    from tpuslam_torch.mapping.graph import (Link, MultiMap, NEIGHBOR,
                                             LOOP_CLOSURE)
    rng = np.random.default_rng(5)
    n = 80
    gt = [from_rpy_xyz(0, 0, 0, 0, 2 * np.pi * i / n, 0) @
          from_rpy_xyz(0, 0, 12.0, 0, 0, 0) for i in range(n)]
    poses, links, cur = {1: gt[0].astype(np.float32)}, MultiMap(), gt[0]
    for i in range(1, n):
        meas = np.linalg.inv(gt[i - 1]) @ gt[i] @ from_rpy_xyz(
            *rng.normal(0, 0.05, 3), *rng.normal(0, 0.01, 3))
        cur = cur @ meas
        poses[i + 1] = cur.astype(np.float32)
        links.insert(i, Link(i, i + 1, NEIGHBOR, meas.astype(np.float32),
                             np.eye(6) * 100.0))
    links.insert(n, Link(n, 1, LOOP_CLOSURE, (np.linalg.inv(gt[-1]) @ gt[0])
                         .astype(np.float32), np.eye(6) * 100.0))
    bad = np.eye(4, dtype=np.float32)
    bad[:3, 3] = [25.0, -13.0, 8.0]
    links.insert(40, Link(40, 5, LOOP_CLOSURE, bad, np.eye(6) * 100.0))
    return poses, links


def test_robust_device_backend_on_the_card_equals_cpu():
    """run_optimize_robust(backend="device") on the card: K7 at least once
    per LM iteration and no plain solve; poses within translations 5e-2
    and chi2 within 10 % of the same call on the CPU, and the gross loop
    closure ejected (an 80-vertex noisy loop, as tests/test_dist.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.optim import pose_graph as PG
    poses, links = _noisy_loop_80()
    rounds, orig = [], PG.get_connected_graph

    def rec(root, p, lk):
        rounds.append(sorted((x.from_id, x.to_id) for x in lk.values()))
        return orig(root, p, lk)
    PG.get_connected_graph = rec
    try:
        _cuda.reset_counters()
        card, card_chi2 = PG.run_optimize_robust(poses, links, 20,
                                                 backend="device")
        torch.cuda.synchronize()
        launches, plain = _cuda.LAUNCHES["thomas"], _cuda.PLAIN_CALLS["thomas"]
    finally:
        PG.get_connected_graph = orig
    cpu, cpu_chi2 = PG.run_optimize_robust(poses, links, 20,
                                           backend="device", device="cpu")
    assert (40, 5) in rounds[0] and (40, 5) not in rounds[-1]
    assert launches >= 5 * (len(rounds) - 1) + 20 and plain == 0
    for k in cpu:
        np.testing.assert_allclose(card[k][:3, 3], cpu[k][:3, 3], rtol=0,
                                   atol=5e-2)
    assert abs(card_chi2 - cpu_chi2) <= 0.1 * cpu_chi2 + 1e-9


@pytest.mark.parametrize("rows", [(), (6,), (6, 6), (6, 3)])
def test_segment_sum_card_equals_cpu(rows):
    """The assembly's segment sum (optim/segment.py) on the card equals
    index_add_ on the CPU bit for bit, signs of zeros included: each
    destination's terms added in edge order, with many repeated
    destinations (one of them 3000 times, as BA's padded observations) and
    exact zeros among the terms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.optim.segment import segment_sum
    rng = np.random.default_rng(len(rows))
    e, n = 8000, 300
    idx = np.concatenate([rng.integers(0, n, e - 3000),
                          np.zeros(3000, np.int64)])
    rng.shuffle(idx)
    x = (rng.normal(0, 1, (e,) + rows) *
         10.0 ** rng.integers(-6, 6, (e,) + rows)).astype(np.float32)
    x[rng.random(e) < 0.1] = -0.0
    want = torch.zeros((n,) + rows).index_add_(0, torch.as_tensor(idx),
                                              torch.as_tensor(x))
    for _ in range(2):
        got = segment_sum(torch.as_tensor(x).cuda(),
                          torch.as_tensor(idx).cuda(), n).cpu()
        assert torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want))


def test_backends_repeat_bit_for_bit():
    """Fault C7: the device back end (run_optimize_robust, backend
    "device") and bundle adjustment (ba_solve with padded observations,
    as global BA runs it) give the same bits when run twice on the card:
    their assembly sums in one order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.optim import pose_graph as PG
    from tpuslam_torch.optim.ba import ba_solve
    poses, links = _noisy_loop_80()
    runs = [PG.run_optimize_robust(poses, links, 20, backend="device")
            for _ in range(2)]
    assert runs[0][1] == runs[1][1]
    for k in runs[0][0]:
        assert np.array_equal(runs[0][0][k], runs[1][0][k])
    rng = np.random.default_rng(4)
    W, L, pad = 8, 256, 2000
    Tcw = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    Tcw[:, 0, 3] = -0.5 * np.arange(W)
    lms = np.stack([rng.uniform(-4, 4, L), rng.uniform(-2, 2, L),
                    rng.uniform(6, 20, L)], 1).astype(np.float32)
    oc = np.concatenate([rng.integers(0, W, 6 * L), np.zeros(pad, int)])
    ol = np.concatenate([np.repeat(np.arange(L), 6), np.zeros(pad, int)])
    valid = np.arange(len(oc)) < 6 * L
    Tn = Tcw.copy()
    Tn[:, :3, 3] += rng.normal(0, 0.02, (W, 3)).astype(np.float32)
    p = np.einsum("wij,lj->wli", Tcw[:, :3, :3], lms) + Tcw[:, None, :3, 3]
    uv = np.stack([500 * p[oc, ol, 0] / p[oc, ol, 2] + 320,
                   500 * p[oc, ol, 1] / p[oc, ol, 2] + 240], 1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    args = [torch.as_tensor(a).cuda() for a in (
        Tn, lms, np.array([500, 500, 320, 240], np.float32),
        oc.astype(np.int64), ol.astype(np.int64), uv, valid)]
    outs = [ba_solve(*args, n_cams=W, n_lms=L, iterations=5,
                     huber_delta=8.0) for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("case", ["fixture", "pattern1", "pattern3",
                                  "pattern5"])
def test_frontend_one_card_equals_cpu(case):
    """dist/mesh.py's frontend_one on the card: K1, K5, K2 and K3's blur
    launcher once each and no plain version; its disparity, response and
    blur equal the CPU's bit for bit (the flat frame-increment pattern
    holds only invalid rows)."""
    _need_card()
    from tpuslam_torch.dist.mesh import frontend_one
    from tpuslam_torch.io.patterns import generate_pattern
    from tpuslam_torch.kernels import _cuda
    if case == "fixture":
        left = np.load(os.path.join(FIXTURES, "rect_left.npy"))
        right = np.load(os.path.join(FIXTURES, "rect_right.npy"))
    else:
        left = right = generate_pattern(int(case[-1]), 480, 640, 7)
    _cuda.reset_counters()
    card = frontend_one(left, right)
    torch.cuda.synchronize()
    assert {k: _cuda.LAUNCHES[k] for k in ("stereo_bm", "lr_check", "gftt",
                                           "orb_blur")} == \
        dict(stereo_bm=1, lr_check=1, gftt=1, orb_blur=1)
    assert sum(_cuda.LAUNCHES.values()) == 4
    assert sum(_cuda.PLAIN_CALLS.values()) == 0
    cpu = frontend_one(left, right, device="cpu")
    for a, b in zip(card, cpu):
        assert a.is_cuda and a.dtype == b.dtype
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.parametrize("block", [3, 5])
def test_response_and_blur_dispatchers_on_the_card(pair, block):
    """gftt_response_auto and orb_blur_auto on a CUDA tensor launch K2 and
    K3's blur and equal the CPU's plain versions bit for bit; at a block
    size K2 refuses (5) the response raises instead of running the plain
    version on the card."""
    from tpuslam_torch.kernels import _cuda, gftt as G, orb as O
    img = pair[0][:1].contiguous()
    _cuda.reset_counters()
    if G.k2_refusal(block) is not None:
        with pytest.raises(ValueError, match="block_size 5"):
            G.gftt_response_auto(img, block)
        assert not any(_cuda.LAUNCHES.values())
        assert not any(_cuda.PLAIN_CALLS.values())
        return
    eig, blur = G.gftt_response_auto(img, block), O.orb_blur_auto(img)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["gftt"] == 1 and _cuda.LAUNCHES["orb_blur"] == 1
    assert not any(_cuda.PLAIN_CALLS.values())
    assert torch.equal(eig.cpu(), G.gftt_response(img.cpu(), block))
    assert torch.equal(blur.cpu(), O.orb_blur(img.cpu()))


def test_kernel_test_card_equals_cpu(tmp_path):
    """cli/kernel_test.py on the card: K1, K5 and K2 once each, no plain
    version; the report equal to the CPU's (the float warp's numbers to
    1e-4), every stage's output equal bit for bit (the float warp to
    1e-4)."""
    _need_card()
    from tpuslam_torch.cli import kernel_test
    from tpuslam_torch.kernels import _cuda
    _cuda.reset_counters()
    card_arrays, cpu_arrays = {}, {}
    card = kernel_test.run(out_dir=str(tmp_path / "card"), quiet=True,
                           arrays=card_arrays)
    launches = dict(_cuda.LAUNCHES)
    assert launches["stereo_bm"] == launches["lr_check"] == \
        launches["gftt"] == 1
    assert sum(launches.values()) == 3
    assert sum(_cuda.PLAIN_CALLS.values()) == 0
    cpu = kernel_test.run(out_dir=str(tmp_path / "cpu"), quiet=True,
                          device="cpu", arrays=cpu_arrays)
    assert card["all_pass"] and card["xsobel_vs_golden"]["mismatches"] == 0
    for key in cpu:
        if key == "rectify_hw_vs_float":
            for k in ("max_abs", "mean_abs"):
                assert card[key][k] == pytest.approx(cpu[key][k], abs=1e-4)
        else:
            assert card[key] == cpu[key], key
    for k, v in cpu_arrays.items():
        if k == "rect_float":
            np.testing.assert_allclose(card_arrays[k], v, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(card_arrays[k], v)


def test_photo_render_card_against_cpu():
    """The photo-textured renderer on the card against the CPU: within one
    grey level on at most 1e-3 of the pixels (exp, sqrt and log2 round
    differently on the two), at the real-texture sequence's 640x240."""
    _need_card()
    from tpuslam_torch.io.synthetic import BoxWorld, forward_trajectory
    photo = np.load(os.path.join(FIXTURES, "rect_left.npy"))
    poses = forward_trajectory(120, 1.4, 0.003)
    world = BoxWorld(poses, seed=11, photo=photo)
    for p in (poses[0], poses[60], poses[119]):
        card = world.render(p, 350.0, 319.5, 119.5, 240, 640)
        cpu = world.render(p, 350.0, 319.5, 119.5, 240, 640, device="cpu")
        assert card.is_cuda
        d = np.abs(card.cpu().numpy().astype(np.int32) -
                   cpu.numpy().astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3


# ------------------------------------------------- the multi-device layer

def test_sharded_frontend_on_the_card(pair):
    """sharded_frontend_step on 2 shards of the card over the fixture pair
    and its mirror: K1, K5, K2 and K3's blur launched once per shard, no
    plain version, every frame's outputs bit for bit frontend_one's."""
    from tpuslam_torch.dist.mesh import (frontend_one, make_mesh,
                                         sharded_frontend_step)
    from tpuslam_torch.kernels import _cuda
    lb, rb = pair
    mesh = make_mesh(2)
    _cuda.reset_counters()
    got = sharded_frontend_step(mesh)(lb, rb)
    torch.cuda.synchronize()
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == dict(
        stereo_bm=2, lr_check=2, gftt=2, orb_blur=2)
    assert not any(_cuda.PLAIN_CALLS.values())
    for i in range(2):
        for a, b in zip(got, frontend_one(lb[i], rb[i])):
            assert torch.equal(a[i], b)


def _noisy_loop_arrays(n=60, seed=3):
    """A noisy loop of n poses (io.synthetic.noisy_circuit: odometry noise
    0.05 m / 0.01 rad, Omega = 100 I) with exact closures last -> first
    and forward 9 -> n - 21 (a Woodbury extra), as optim.device graph
    arrays."""
    from tpuslam_torch.io.synthetic import exact_closure, noisy_circuit
    from tpuslam_torch.optim import device as dev
    gt, poses, links = noisy_circuit(n, n, np.random.default_rng(seed))
    exact_closure(links, gt, n - 1, 0)
    exact_closure(links, gt, 9, n - 21)
    return dev.graph_to_arrays(poses, links)[1:]


def test_sharded_sparse_step_root_solve_on_k7():
    """The sparse sharded step on 4 shards of the card: K7 launched once
    per iteration (the root solve on global shard 0 alone), no plain
    solve; within chi2 rtol 2e-3 and translations 2e-2 m of
    lm_solve_sparse on the card and of the same step on the CPU."""
    _need_card()
    from tpuslam_torch.dist.mesh import (make_mesh, pad_edges,
                                         sharded_pose_graph_step_sparse)
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.optim import device as dev
    pose_arr, e_from, e_to, Z, Omega, free_idx = _noisy_loop_arrays()
    V, it = len(pose_arr), 5
    xsel, xp, xq = dev.classify_extra_edges(e_from, e_to, free_idx)
    assert len(xp) == 1
    ef, et, Zp, Op = pad_edges(e_from, e_to, Z, Omega, 4)
    xsel_p = np.full(len(ef), -1, np.int32)
    xsel_p[:len(xsel)] = xsel
    args = (pose_arr, ef, et, Zp, Op, free_idx, xsel_p, xp, xq)
    _cuda.reset_counters()
    card = sharded_pose_graph_step_sparse(make_mesh(4, axis="edges"), V - 1,
                                          iterations=it)(*args)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["thomas"] == it and not any(
        _cuda.PLAIN_CALLS.values())
    cpu = sharded_pose_graph_step_sparse(
        make_mesh(4, axis="edges", device="cpu"), V - 1,
        iterations=it)(*args)
    ref = dev.lm_solve_sparse(*(torch.as_tensor(a, device="cuda") for a in (
        pose_arr, e_from, e_to, Z, Omega, free_idx)), V - 1,
        *(torch.as_tensor(a, device="cuda") for a in (xsel, xp, xq)),
        iterations=it)
    for other in (cpu, ref):
        np.testing.assert_allclose(card[1].cpu().numpy(),
                                   other[1].cpu().numpy(), rtol=2e-3)
        np.testing.assert_allclose(card[0].cpu().numpy()[:, :3, 3],
                                   other[0].cpu().numpy()[:, :3, 3], rtol=0,
                                   atol=2e-2)


def test_two_gloo_ranks_on_the_card(tmp_path):
    """tools/dist_worker.py as two gloo ranks sharing the card and as one
    process, over a 6-frame 320x240 sequence rendered on the card: the
    ranks' poses equal each other, the VO poses and the partitioned
    mapper's words and links the one process's bit for bit, and the
    single-process Mapper's; the words split by parity; K1, K5, K2 and K3
    launched in each rank's VO and K7 on rank 0 only, no plain version."""
    _need_card()
    import json
    import socket
    import subprocess
    import sys
    from tpuslam_torch.io.synthetic import write_sequence
    seq = write_sequence(str(tmp_path / "seq"), n_frames=6, width=320,
                         height=240, f=260.0, baseline=0.54, speed=0.3,
                         seed=9)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        coord = f"localhost:{s.getsockname()[1]}"
    worker = [sys.executable, "-m", "tpuslam_torch.tools.dist_worker", seq]
    cmds = [worker + [str(tmp_path / "two"), coord, "2", str(r), "--backend",
                      "gloo", "--chunk", "4"] for r in range(2)]
    cmds.append(worker + [str(tmp_path / "one"), "-", "1", "0", "--chunk",
                          "4"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(c, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    logs = [p.communicate(timeout=600)[0].decode(errors="replace")
            for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    r0, r1 = (np.load(tmp_path / "two" / f"rank{i}.npz") for i in range(2))
    one = np.load(tmp_path / "one" / "rank0.npz")
    for k in ("poses", "opt_poses", "sp_opt_poses", "pm_words", "pm_links",
              "pm_link_tfs", "pm_lik"):
        np.testing.assert_array_equal(r0[k], r1[k])
    for k in ("poses", "pm_words", "pm_links", "pm_link_tfs"):
        np.testing.assert_array_equal(r0[k], one[k])
    for k in ("words", "links", "link_tfs"):
        np.testing.assert_array_equal(r0["pm_" + k], r0["sm_" + k])
    w0, w1 = (set(r["owned_words"].tolist()) for r in (r0, r1))
    assert not w0 & w1 and len(w0) + len(w1) == int(r0["total_words"])
    assert all(w % 2 == 0 for w in w0) and all(w % 2 == 1 for w in w1)
    for i, r in enumerate((r0, r1)):
        la = json.loads(str(r["launches"]))
        assert not any(v for part in json.loads(str(r["plain"])).values()
                       for v in part.values())
        for k in ("stereo_bm", "lr_check", "gftt", "orb", "lm_refine"):
            assert la["vo"][k] >= 1, (i, k, la)
        assert la["pose_graph"]["thomas"] == (5 if i == 0 else 0)
