"""GPU smoke test of the tpuslam_torch main paths, run from the repo root:

    python3 chip_smoke.py [--spread N]

Needs one CUDA card and nvcc (/usr/local/cuda); imports neither JAX nor
tpuslam.  Phases, each of which raises on failure:

1. device: refuse to run without CUDA; print torch/CUDA versions and the
   card's name and power limit (nvidia-smi);
2. build: compile the six hand-written kernels (tpuslam_torch/csrc/*.cu)
   in parallel into build/tpuslam_torch/ and print the seconds;
3. kernels: render the bench's 1241x376 sequence on the card, then hold
   each kernel to its plain PyTorch version at main-path shapes and time
   both (tpuslam_torch/tools/timing.py: median of 20 runs between CUDA
   events behind a ~1 ms spin, so the host's dispatch stays out; the
   kernel's unspun time, dispatch included, beside it as call_ms; the
   card's launch floor, an empty spin timed the same way, once): K1
   StereoBM, K2 GFTT response+dilation, K3 ORB, K4 covariance medians and
   K5 LR check exactly, and K3's two halves alone (the `orb_blur` and
   `orb_tests` tool launchers) each against its plain half; print K2's,
   K3's, K4's and K5's registers, shared and local memory;
4. K1 phases: the phase harness (tpuslam_torch/tools/probe_bm_parts.py)
   on the same chunk: K1 cut after each of its seven phases, each cut
   equal to its plain twin (the full one also to K1), each timed;
5. main path: what bench.py runs -- FastSlamPipeline.run_staged over the
   120 frames in SlamConfig() with a Mapper (async loop closure, device
   dictionary), once warm and once timed, every counter reset just before
   the timed run; assert each of the six kernels ran, the phase harness
   and the plain versions did not, one Mapper node per frame and a
   non-empty dictionary, bench.py:240's gates (0 lost, median inliers
   >= 300, t_err <= 1 %) and ATE within the bound of PERF.md;
6. K6: the LM refine against its plain version to rvec 1e-5, tvec 1e-4
   and the same inliers at 2 px, timed, on the arguments the warm run's VO
   step gave it at frame 1, and on a scene with a known pose;
7. post-loop: the robust pose graph and global BA on the timed run's
   Mapper; assert finite poses and a non-empty graph;
8. slice path: the first slice's configuration (no LR check, no refine,
   no Mapper), timed, with its own counters (K1-K4) and ATE bound.

With --spread N the main path is run again with RANSAC seeds 1..N and the
quality of each is printed (the data behind PERF.md's ATE bound).

Prints fps, inliers, ATE and KITTI errors, one JSON line of per-kernel
numbers (the harness's row with its per-phase numbers under "phases"), the
nvidia-smi line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# the bench sequence (bench.py:30-37) and chunking
N_FRAMES, WIDTH, HEIGHT = 120, 1241, 376
FOCAL, BASELINE, SPEED, YAW, SEED = 718.856, 0.54, 1.4, 0.003, 11
CHUNK, CAPACITY = 30, 1536
# bench.py:240's gates for the default configuration
MAX_LOST, MIN_MEDIAN_INLIERS, MAX_T_ERR_PCT = 0, 300, 1.0
# yardsticks, tpuslam (JAX) on the CPU on this sequence
# (tools/port_yardstick.py): SlamConfig() with a Mapper, ATE 0.5191 m;
# the slice configuration, ATE 0.5956 m.  The port draws its RANSAC
# hypotheses from a torch.Generator, so it is held to registration noise;
# PERF.md "End-to-end metrics" gives the seed spreads behind the bounds
# (main path: 0.4727-0.5654 m over ten seeds on the card)
ATE_BOUND_M = 0.75
SLICE_ATE_BOUND_M = 1.0
# K6 against its plain version: f32 reduction order (tests/test_pnp.py)
LM_TOL = dict(rvec=1e-5, tvec=1e-4, inlier_px=2.0)


def log(msg):
    print(msg, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    log(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"# card: {smi}")
    return smi


def max_abs_err(a, b):
    return float((a.double() - b.double()).abs().max())


def recording_refines(n_calls):
    """Make the first `n_calls` calls of the LM-refine entry point that the
    VO step and the loop-closure registration call record copies of their
    arguments.  Returns (the recorded argument lists, restore)."""
    from tpuslam_torch.kernels import pnp as P
    orig = P.refine_lm_with_errors_auto
    calls = []

    def recording(*args):
        if len(calls) < n_calls:
            calls.append([a.clone() for a in args])
        return orig(*args)

    P.refine_lm_with_errors_auto = recording
    return calls, lambda: setattr(P, "refine_lm_with_errors_auto", orig)


def record(rows, name, src, replaces, kernel, plain, outs_k, outs_p,
           nbytes, ops, tol=0.0):
    """Hold a kernel's outputs to its plain version's within `tol`, time
    both (spun; the kernel also unspun), and add the kernel's row to
    `rows`."""
    from tpuslam_torch.tools.timing import bound, call_ms, time_ms
    err = max(max_abs_err(k, p) for k, p in zip(outs_k, outs_p))
    if not err <= tol:
        raise AssertionError(f"{name}: kernel differs from plain "
                             f"version (max abs err {err} > {tol})")
    b_ms, b_by = bound(nbytes, ops)
    rows[name] = dict(name=name, route="cuda", source=src,
                      replaces=replaces, max_abs_err=err,
                      ms=time_ms(kernel), call_ms=call_ms(kernel),
                      plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
                      library_ms=None)
    log(f"# {name}: max abs err {err} (tolerance {tol}); kernel "
        f"{rows[name]['ms']:.4f} ms (unspun {rows[name]['call_ms']:.4f} "
        f"ms), plain {rows[name]['plain_ms']:.3f} ms, bound {b_ms:.5f} ms "
        f"({b_by})")


def sampled_pixels(kp, valid, H, W):
    """The distinct in-image pixels that K3's tests read at the valid
    keypoints (B, K, 2): the bytes its tests half must load."""
    from tpuslam_torch.kernels import orb as O
    dxs, dys, _ = O._const_angle_offsets(-1.0)
    cx, cy = O._centers(kp, H, W)
    dev = kp.device
    x = cx[..., None] + torch.as_tensor(dxs, device=dev).long()
    y = cy[..., None] + torch.as_tensor(dys, device=dev).long()
    frame = torch.arange(kp.shape[0], device=dev)[:, None, None]
    keep = valid[..., None] & (x >= 0) & (x < W) & (y >= 0) & (y < H)
    return int(torch.unique(((frame * H + y) * W + x)[keep]).numel())


def kernel_phase(lefts, rights, cfg):
    """K1-K5 against their plain versions on the card, at main-path
    shapes: the first 30-frame chunk of the rendered sequence."""
    from tpuslam_torch.kernels import stereo_bm as BM, gftt as G, orb as O
    from tpuslam_torch.vo import fused as F
    rows = {}
    B, H, W = lefts.shape
    px = B * H * W

    # K1: disparity and min-SAD of 30 frames.  Bound: the pair in (2 B),
    # int16 disparity and int32 min-SAD out (6 B) per pixel; per pixel and
    # disparity an absolute difference, two running-sum updates per box
    # direction and a compare (6 operations)
    kb = BM.stereo_bm_cuda(lefts, rights, cfg.bm)
    pb = BM.stereo_bm_plain(lefts, rights, cfg.bm)
    record(rows, "stereo_bm", "tpuslam_torch/csrc/stereo_bm.cu",
           "tpuslam/kernels/stereo_bm_pallas.py:423",
           lambda: BM.stereo_bm_cuda(lefts, rights, cfg.bm),
           lambda: BM.stereo_bm_plain(lefts, rights, cfg.bm), kb, pb,
           8 * px, 6 * cfg.bm.num_disparities * px)
    valid_px = float((pb[0] >= 0).float().mean())
    regs, smem, blocks = BM.stereo_bm_phase_occupancy("full")
    log(f"# stereo_bm: {valid_px:.3f} of pixels hold a disparity; "
        f"{regs} registers, {smem} B shared memory, {blocks} blocks of "
        f"256 threads per SM")

    # K5: the left-right check on K1's outputs.  Bound: int16 disparity
    # and int32 min-SAD in, int16 disparity out (8 B per pixel); ~20
    # integer operations per pixel for the projection and the two checks
    kl = BM.lr_check_cuda(*kb, cfg.bm)
    pl = BM.lr_check_plain(*pb, cfg.bm)
    record(rows, "lr_check", "tpuslam_torch/csrc/lr_check.cu",
           "tpuslam/kernels/stereo_bm_pallas.py:355",
           lambda: BM.lr_check_cuda(*kb, cfg.bm),
           lambda: BM.lr_check_plain(*pb, cfg.bm), (kl,), (pl,),
           8 * px, 20 * px)
    log(f"# lr_check: {int((kl != kb[0]).sum())} pixels invalidated")
    la = BM.lr_check_kernel_attrs(W)
    log(f"# lr_check kernel (W = {W}): {la['registers']} registers, "
        f"{la['shared_bytes']} B shared memory, {la['local_bytes']} B local "
        f"memory per thread, {la['rows']} rows (a warp each) per block, "
        f"{la['columns_per_lane']} columns per lane")

    # K2: response (compared bit for bit) and dilation.  Bound: image in
    # (1 B), response and dilation out (8 B) per pixel; ~40 operations per
    # pixel (Sobel pair, three products, three 3x3 box sums, the
    # eigenvalue, the dilation)
    ke, kd = G.gftt_response_dil_cuda(lefts)
    pe, pd = G.gftt_response_dil_plain(lefts)
    record(rows, "gftt", "tpuslam_torch/csrc/gftt.cu",
           "tpuslam/kernels/gftt.py:195",
           lambda: G.gftt_response_dil_cuda(lefts),
           lambda: G.gftt_response_dil_plain(lefts),
           (ke.view(torch.int32), kd), (pe.view(torch.int32), pd),
           9 * px, 40 * px)
    # the kernel path's raw-dilation candidate mask equals the plain
    # path's thresholded one
    thr = (pe.amax(dim=(1, 2)) * torch.tensor(
        cfg.gftt.quality_level, dtype=torch.float32, device=pe.device))
    z = torch.where(pe > thr[:, None, None], pe, 0.0)
    m_plain = (z != 0) & (z == G.local_max_3x3(z))
    m_kern = (ke > thr[:, None, None]) & (ke == kd)
    if not torch.equal(m_plain, m_kern):
        raise AssertionError("gftt: raw-dilation mask != thresholded mask")
    ga = G.gftt_kernel_attrs()
    log(f"# gftt kernel: {ga['registers']} registers, {ga['shared_bytes']} B "
        f"shared memory, {ga['local_bytes']} B local memory per thread, "
        f"strips of {ga['strip_rows']}x{ga['strip_cols']} outputs, "
        f"{ga['warps']} per block")

    # K3: descriptors at the plain path's keypoints (computed on the host).
    # Bound: the image in once (1 B per pixel), keypoints in (8 B) and
    # descriptors out (32 B); a separable 7x7 blur of the image
    # (28 operations per pixel) and 256 compares per keypoint
    kp, valid, n_k = F.detect_keypoints(lefts.cpu(), cfg)
    kp = kp[..., :2].contiguous().to(lefts.device)
    valid = valid.to(lefts.device)
    log(f"# keypoints per frame: min {int(n_k.min())}, "
        f"max {int(n_k.max())}")
    nkp = int(n_k.sum())
    kdsc = O.orb_descriptors_cuda(lefts, kp, valid)
    pdsc = O.orb_descriptors_plain(lefts, kp, valid)
    record(rows, "orb", "tpuslam_torch/csrc/orb.cu",
           "tpuslam/kernels/orb.py:283",
           lambda: O.orb_descriptors_cuda(lefts, kp, valid),
           lambda: O.orb_descriptors_plain(lefts, kp, valid),
           (kdsc,), (pdsc,), px + 40 * nkp, 28 * px + 256 * nkp)
    # K3's halves alone (tool launchers), each against its plain half.
    # Blur bound: the image in and the blurred image out (2 B per pixel),
    # 28 operations per pixel.  Tests bound: the distinct blurred pixels
    # that this run's keypoints sample, keypoints in and descriptors out,
    # 256 compares per keypoint
    kblur = O.orb_blur_cuda(lefts)
    pblur = O.orb_blur(lefts)
    record(rows, "orb_blur", "tpuslam_torch/csrc/orb.cu",
           "tpuslam/kernels/orb.py:283",
           lambda: O.orb_blur_cuda(lefts), lambda: O.orb_blur(lefts),
           (kblur,), (pblur,), 2 * px, 28 * px)
    ktst = O.orb_tests_cuda(pblur, kp, valid)
    ptst = O.descriptors_from_blurred(pblur, kp, valid)
    record(rows, "orb_tests", "tpuslam_torch/csrc/orb.cu",
           "tpuslam/kernels/orb.py:283",
           lambda: O.orb_tests_cuda(pblur, kp, valid),
           lambda: O.descriptors_from_blurred(pblur, kp, valid),
           (ktst,), (ptst,), sampled_pixels(kp, valid, H, W) + 40 * nkp,
           256 * nkp)
    for half, a in O.orb_kernel_attrs().items():
        log(f"# orb {half} kernel: {a['registers']} registers, "
            f"{a['shared_bytes']} B shared memory, {a['local_bytes']} B "
            f"local memory per thread")

    # K4: ties, +inf, all-masked and one-valid rows, N = capacity.  Bound
    # (timed row): two f32 rows and the mask in (9 B per entry), a few
    # operations per entry for two selections
    rng = np.random.default_rng(SEED)
    n = CAPACITY
    a = np.abs(rng.normal(0, 10, (5, n))).astype(np.float32)
    b = np.abs(rng.normal(0, 2, (5, n))).astype(np.float32)
    a[1] = np.round(a[1])
    a[2, ::3] = np.inf
    m = rng.uniform(size=(5, n)) < 0.5
    m[3] = False
    m[4] = False
    m[4, n // 3] = True
    a, b, m = (torch.as_tensor(v, device=lefts.device) for v in (a, b, m))
    km = F.masked_median2_cuda(a, b, m)
    pm = F.masked_median2_plain(a, b, m)
    one = (a[:1].contiguous(), b[:1].contiguous(), m[:1].contiguous())
    record(rows, "median", "tpuslam_torch/csrc/median.cu",
           "tpuslam/vo/fused.py:195",
           lambda: F.masked_median2_cuda(*one),
           lambda: F.masked_median2_plain(*one), km,
           (pm[0], pm[1], pm[2].int()), 9 * n, 8 * n)
    ma = F.median_kernel_attrs(n)
    log(f"# median kernel (N = {n}): {ma['registers']} registers, "
        f"{ma['shared_bytes']} B shared memory, {ma['local_bytes']} B local "
        f"memory per thread, {ma['keys_per_thread']} keys per thread")
    return rows


def k1_phases_phase(rows, lefts, rights, cfg):
    """The K1 phase harness on the first chunk: every phase of K1 equal to
    its plain twin (raises otherwise), timed; its row counts the harness's
    launches (the main path never launches it)."""
    from tpuslam_torch.tools import probe_bm_parts as PB
    res = PB.run(lefts, rights, cfg.bm)
    for line in PB.table(res).splitlines():
        log(f"# K1 phases: {line}")
    rows["stereo_bm_phase"] = dict(
        name="stereo_bm_phase", route="cuda",
        source="tpuslam_torch/csrc/stereo_bm.cu",
        replaces="tools/probe_bm_parts.py:148", library_ms=None,
        phases={n: {k: p[k] for k in ("ms", "net_ms", "bound_ms", "bound_by",
                                       "blocks_per_sm") if k in p}
                for n, p in res["phases"].items()},
        **{k: res[k] for k in ("launches", "max_abs_err", "ms", "call_ms",
                               "plain_ms", "bound_ms", "bound_by")})


def lm_phase(rows, frame1_args, camera, cfg):
    """K6, the LM refine, against its plain version to LM_TOL: on the
    arguments the main path's VO step gave it at frame 1 (timed), and on a
    scene with a known pose.  Bound: per point obj, img, weight, valid in
    and the error out (29 B); 21 evaluations of ~150 operations per
    point."""
    from tpuslam_torch.io.synthetic import pnp_scene
    from tpuslam_torch.kernels import pnp as P

    def lm_check(args, what):
        kr, kt, ke_ = P.refine_lm_errors_cuda(*args)
        pr, pt, pe_ = P.refine_lm_with_errors(*args)
        thr_px = LM_TOL["inlier_px"]
        if not torch.equal(ke_ <= thr_px, pe_ <= thr_px):
            raise AssertionError(f"lm_refine ({what}): inlier sets at "
                                 f"{thr_px} px differ")
        for nm, x, y in (("rvec", kr, pr), ("tvec", kt, pt)):
            if not max_abs_err(x, y) <= LM_TOL[nm]:
                raise AssertionError(f"lm_refine ({what}): {nm} differs by "
                                     f"{max_abs_err(x, y)}")
        log(f"# lm_refine ({what}): rvec err {max_abs_err(kr, pr):.3g}, "
            f"tvec err {max_abs_err(kt, pt):.3g}, weight sum "
            f"{float(args[2].sum()):.0f}, {int((ke_ <= thr_px).sum())} "
            f"inliers of {len(ke_)}")
        return (kr, kt), (pr, pt)

    scene, rv_true, tv_true = pnp_scene(np.random.default_rng(SEED),
                                        CAPACITY, camera.K_l)
    (kr, kt), _ = lm_check(scene, "known pose")
    if not (np.abs(kr.cpu().numpy() - rv_true).max() < 2e-3 and
            np.abs(kt.cpu().numpy() - tv_true).max() < 2e-2):
        raise AssertionError("lm_refine: known pose not recovered")
    args = [a.contiguous() for a in frame1_args]
    if not float(args[2].sum()) >= cfg.pnp.min_inliers:
        raise AssertionError("lm_refine: the recorded frame-1 call has "
                             "too few weighted rows")
    n_c = len(args[0])
    outs_k, outs_p = lm_check(args, "main path, frame 1")
    record(rows, "lm_refine", "tpuslam_torch/csrc/lm_refine.cu",
           "tpuslam/kernels/pnp.py:1067",
           lambda: P.refine_lm_errors_cuda(*args),
           lambda: P.refine_lm_with_errors(*args), outs_k, outs_p,
           29 * n_c, 21 * 150 * n_c, tol=LM_TOL["tvec"])


def quality(infos, gt):
    est = np.stack([i.pose for i in infos])
    if len(infos) != N_FRAMES or not np.isfinite(est).all():
        raise AssertionError("poses missing or not finite")
    from tpuslam_torch.geometry.kitti_metric import \
        calc_kitti_sequence_errors
    inl = sorted(i.num_inliers for i in infos[1:])
    t_err, r_err = calc_kitti_sequence_errors(gt, est)
    return dict(lost=sum(1 for i in infos[1:] if i.lost),
                median_inliers=inl[len(inl) // 2], min_inliers=inl[0],
                ate=float(np.sqrt(np.mean(np.sum(
                    (est[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=1)))),
                t_err=t_err, r_err=r_err)


def fmt(q):
    return (f"lost={q['lost']}, median inliers={q['median_inliers']}, "
            f"min inliers={q['min_inliers']}, ATE={q['ate']:.4f} m, "
            f"t_err={q['t_err']:.4f} %, r_err={q['r_err']:.6f} deg/m")


def timed_run(pipe, staged, items, gt, what, with_mapper, n_record=0):
    """A warm run that records the arguments of the first `n_record`
    LM-refine calls, then every counter reset and a timed run.  Returns
    (quality, fps, launches, plain calls, mapper, recorded calls)."""
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.mapping.mapper import Mapper

    def mapper():
        if not with_mapper:
            return None
        mp = Mapper(pipe.camera, pipe.cfg.mapper, pipe.cfg.matching,
                    pipe.cfg.pnp)
        mp.async_lc = True
        return mp

    calls, restore = recording_refines(n_record)
    t0 = time.perf_counter()
    try:
        pipe.run_staged(staged, items, mapper=mapper(),
                        mapper_async=with_mapper)
    finally:
        restore()
    log(f"# {what}: warm run {time.perf_counter() - t0:.2f} s")
    pipe.reset()
    mp = mapper()
    _cuda.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    infos = pipe.run_staged(staged, items, mapper=mp,
                            mapper_async=with_mapper)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
    q = quality(infos, gt)
    log(f"# {what}: {N_FRAMES} frames {WIDTH}x{HEIGHT} in {dt:.3f} s = "
        f"{N_FRAMES / dt:.3f} fps; {fmt(q)}")
    log(f"# {what}: launches {launches}, plain calls {plain}")
    return q, N_FRAMES / dt, launches, plain, mp, calls


def main_path_phase(camera, cfg, staged, items, gt):
    """bench.py's run: SlamConfig() with a Mapper (async LC, device
    dictionary)."""
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    pipe = FastSlamPipeline(camera, cfg, chunk=CHUNK, capacity=CAPACITY,
                            seed=SEED)
    q, fps, launches, plain, mapper, calls = timed_run(
        pipe, staged, items, gt, "main path", with_mapper=True, n_record=2)
    missing = [k for k in _cuda.KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if any(v != 0 for v in plain.values()):
        raise AssertionError(f"a plain version ran: {plain}")
    if any(launches[k] != 0 for k in _cuda.TOOLS):
        raise AssertionError(f"a tool ran on the main path: {launches}")
    log(f"# mapper: {len(mapper.nodes)} nodes, {mapper.vwd._count} words, "
        f"{len(mapper.loop_closures)} loop closures")
    if len(mapper.nodes) != N_FRAMES or not mapper.vwd._count > 0:
        raise AssertionError("the Mapper lacks a node per frame or words")
    if q["lost"] > MAX_LOST or q["median_inliers"] < MIN_MEDIAN_INLIERS \
            or not q["t_err"] <= MAX_T_ERR_PCT:
        raise AssertionError(f"bench gates failed: {fmt(q)}")
    if not q["ate"] <= ATE_BOUND_M:
        raise AssertionError(f"ATE {q['ate']} m above the bound "
                             f"{ATE_BOUND_M} m")
    # the VO step refines once per frame: call 1 is frame 1's
    return mapper, launches, fps, calls[1]


def post_loop_phase(mapper, camera, cfg, gt):
    """bench.py:220-239: robust pose graph, then global BA."""
    from tpuslam_torch.geometry.kitti_metric import \
        calc_kitti_sequence_errors
    from tpuslam_torch.mapping.ba_window import refine_trajectory_global_ba
    from tpuslam_torch.optim import run_optimize_robust
    t0 = time.perf_counter()
    poses, links = mapper.get_graph()
    if not poses or not len(links):
        raise AssertionError("the Mapper's graph is empty")
    optimized, chi2 = run_optimize_robust(poses, links, 20, cfg.optimizer)
    t1 = time.perf_counter()
    ba_poses = refine_trajectory_global_ba(mapper, optimized, camera)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ids = sorted(optimized)
    gt_n = gt[[i - 1 for i in ids]]
    for name, pd in (("posegraph", optimized), ("ba", ba_poses)):
        est_n = np.stack([pd[i] for i in ids])
        if not np.isfinite(est_n).all():
            raise AssertionError(f"{name}: poses not finite")
        ate = float(np.sqrt(np.mean(np.sum(
            (est_n[:, :3, 3] - gt_n[:, :3, 3]) ** 2, axis=1))))
        te, re_ = calc_kitti_sequence_errors(gt_n, est_n)
        log(f"# {name}: ATE={ate:.4f} m, t_err={te:.4f} %, "
            f"r_err={re_:.6f} deg/m")
    log(f"# post-loop: {len(poses)} nodes, {len(links)} links, chi2 "
        f"{chi2:.6g}; pose graph {t1 - t0:.2f} s, global BA "
        f"{t2 - t1:.2f} s (host wall)")


def slice_phase(camera, staged, items, gt):
    """The first slice's path: no LR check, no LM refine, no Mapper."""
    from tpuslam_torch.config import SlamConfig, StereoBMConfig, PnPConfig
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    cfg = SlamConfig().replace(bm=StereoBMConfig(disp12_max_diff=-1),
                               pnp=PnPConfig(refine_iterations=0))
    pipe = FastSlamPipeline(camera, cfg, chunk=CHUNK, capacity=CAPACITY,
                            seed=SEED)
    q, fps, launches, plain, _, _ = timed_run(
        pipe, staged, items, gt, "slice path", with_mapper=False)
    need = ("stereo_bm", "gftt", "orb", "median")
    if any(launches[k] == 0 for k in need) or any(plain.values()):
        raise AssertionError(f"slice path: launches {launches}, plain "
                             f"{plain}")
    if q["lost"] > MAX_LOST or not q["ate"] <= SLICE_ATE_BOUND_M:
        raise AssertionError(f"slice path quality: {fmt(q)}")
    return fps


def spread_phase(camera, cfg, staged, items, gt, n):
    """The main path with RANSAC seeds 1..n (quality only)."""
    from tpuslam_torch.mapping.mapper import Mapper
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    ates = []
    for seed in range(1, n + 1):
        pipe = FastSlamPipeline(camera, cfg, chunk=CHUNK, capacity=CAPACITY,
                                seed=seed)
        mp = Mapper(camera, cfg.mapper, cfg.matching, cfg.pnp)
        mp.async_lc = True
        t0 = time.perf_counter()
        infos = pipe.run_staged(staged, items, mapper=mp, mapper_async=True)
        dt = time.perf_counter() - t0
        q = quality(infos, gt)
        ates.append(q["ate"])
        log(f"# spread seed {seed}: {N_FRAMES / dt:.3f} fps; {fmt(q)}")
    log(f"# spread over {n} seeds: ATE {min(ates):.4f}-{max(ates):.4f} m")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spread", type=int, default=0)
    args = ap.parse_args()
    smi = device_phase()
    import tpuslam_torch  # noqa: F401  (applies the precision pin)
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.config import SlamConfig
    from tpuslam_torch.io.synthetic import make_sequence, sequence_camera
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    from tpuslam_torch.tools.timing import floor_ms

    t0 = time.perf_counter()
    took = _cuda.build_all()
    for name in _cuda.KERNELS + _cuda.TOOLS:
        _cuda.launcher(name)
    log(f"# build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")

    cfg = SlamConfig()       # bench.py's configuration, unchanged
    t0 = time.perf_counter()
    lefts, rights, stamps, gt = make_sequence(
        N_FRAMES, WIDTH, HEIGHT, FOCAL, BASELINE, SPEED, YAW, SEED)
    torch.cuda.synchronize()
    log(f"# rendered {N_FRAMES} stereo pairs on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    camera = sequence_camera(WIDTH, HEIGHT, FOCAL, BASELINE)

    floor = floor_ms()
    log(f"# launch floor: {floor:.4f} ms (an empty spin between two events,"
        f" behind the ~1 ms spin)")
    chunk = (lefts[:CHUNK].contiguous(), rights[:CHUNK].contiguous())
    rows = kernel_phase(*chunk, cfg)
    k1_phases_phase(rows, *chunk, cfg)
    items = [dict(left=lefts[i], right=rights[i], stamp=stamps[i],
                  ground_truth=gt[i]) for i in range(N_FRAMES)]
    staged = FastSlamPipeline(camera, cfg, chunk=CHUNK,
                              capacity=CAPACITY).stage_chunks(items)
    mapper, launches, fps, frame1_args = main_path_phase(
        camera, cfg, staged, items, gt)
    lm_phase(rows, frame1_args, camera, cfg)
    post_loop_phase(mapper, camera, cfg, gt)
    slice_fps = slice_phase(camera, staged, items, gt)
    log(f"# fps: default configuration + Mapper {fps:.3f}, slice "
        f"{slice_fps:.3f}")
    if args.spread:
        spread_phase(camera, cfg, staged, items, gt, args.spread)

    for name, row in rows.items():
        if name in _cuda.KERNELS:
            row["launches"] = launches[name]
        elif name in ("orb_blur", "orb_tests"):
            # the halves' kernels run on the main path inside K3's
            # launches; their own tool launchers never do
            row.update(launches=launches["orb"], via="orb",
                       tool_launches=launches[name])
        row["floor_ms"] = floor
        if not all(math.isfinite(row[k]) for k in (
                "ms", "call_ms", "plain_ms", "bound_ms", "floor_ms")):
            raise AssertionError(f"{name}: a time is not finite: {row}")
    kernels = [{k: rows[n][k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "floor_ms",
        "library_ms", "via", "tool_launches", "phases") if k in rows[n]}
        for n in _cuda.KERNELS + _cuda.TOOLS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
