"""GPU smoke test of the tpuslam_torch main paths, run from the repo root:

    python3 chip_smoke.py [--spread N] [--parent DIR]

Needs one CUDA card and nvcc (/usr/local/cuda); imports neither JAX nor
tpuslam.  Phases, each of which raises on failure:

1. device: refuse to run without CUDA; print torch/CUDA versions and the
   card's name and power limit (nvidia-smi);
2. build: compile the six hand-written kernels (tpuslam_torch/csrc/*.cu)
   in parallel into build/tpuslam_torch/, and the native image decoder
   (csrc/loader.cpp, g++), and print the seconds;
3. kernels: render the bench's 1241x376 sequence on the card, then hold
   each kernel to its plain PyTorch version at main-path shapes and time
   both (tpuslam_torch/tools/timing.py: median of 20 runs between CUDA
   events behind a ~1 ms spin, so the host's dispatch stays out; the
   kernel's unspun time, dispatch included, beside it as call_ms; the
   card's launch floor, an empty spin timed the same way, once): K1
   StereoBM, K2 GFTT response+dilation, K3 ORB, K4 covariance medians and
   K5 LR check exactly, and K3's two halves alone (the `orb_blur` and
   `orb_tests` tool launchers) each against its plain half; print K1's
   tile shape, K1's, K2's, K3's, K4's and K5's registers, shared and
   local memory (K1: and blocks per SM);
4. K1 phases: the phase harness (tpuslam_torch/tools/probe_bm_parts.py)
   on the same chunk: K1 cut after each of its seven phases, each cut
   equal to its plain twin (the full one also to K1), each timed; then
   K1's wide kernel, which runs the configurations its packed kernel
   cannot take (another disparity count, a block beyond 31, costs past
   uint16), at six of them on one frame and at 128 disparities on the
   chunk, each equal to its plain twin, timed, with its launch shape and
   occupancy;
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
   Mapper; assert finite poses and a non-empty graph, and global BA run
   twice on the same input bit for bit (its sums take one order);
8. slice path: the first slice's configuration (no LR check, no refine,
   no Mapper), timed, with its own counters (K1-K4) and ATE bound;
9. ingest: bench.py's ingest pass -- the 120 frames written as PNGs (rows
   filtered as libpng filters them), then FastSlamPipeline.run_ingest
   from those files (native decoder threads, pinned rotating buffers,
   uploads on a copy stream) with an async Mapper, once warm and once
   timed, every counter reset just before the timed run; assert what
   phase 5 asserts and that every frame the loop uploaded equals the
   rendered one; print ingest fps beside phase 5's staged fps, the pure
   host-to-device ceiling of the same bytes from pinned memory and
   ingest_efficiency = min(1, ingest fps / ceiling fps) (bench.py:160-187),
   both decoders' ms per image at the written mix and with every row
   Paeth, and the largest pose difference to phase 5's timed run; then
   two more pairs of timed runs, staged and ingest in turns, and the
   medians of each;
10. per-frame batch path: write a 61-frame out-and-back 1241x376 sequence
   (KITTI layout, PNGs) rendered on the card, then run the batch app
   (tpuslam_torch.cli.slam_batch.run, SlamConfig() with a small-memory
   Mapper) over it, a few frames warm and all of them timed, every counter
   reset just before the timed run; assert K1, K2, K3 and K5 once per
   frame, K6 more often than the odometry's registrations alone (loop
   closure ran on the card), K4 never, no plain version, a node per
   frame, a loop closure, no lost frame, the five output files, occupied
   voxels and ATE within the bound of PERF.md; then hold K1, K5, K2, K3
   and K6 to their plain versions at this path's shapes (frame 0 of the
   timed run as a (1, 376, 1241) pair, its keypoints padded to 1536, the
   first odometry and the first loop-closure LM-refine call's arguments),
   bit for bit (K6 to rvec 1e-5, tvec 1e-4, the same inliers), and each
   timed; the kernels reproduce frame 0's disparity and descriptors of
   the run; hold the speckle filter on the card to the CPU bit for bit
   (one frame, and a 30-frame batch); print fps, the perf spans' totals,
   the speckle rounds, the PNG decode time and the written files' row
   filters (chosen per row as libpng and Pillow choose); then run the
   path once more over the same images with every row Paeth-filtered, as
   Pillow filters most rows of a photograph, and print its fps.  The path
   reads through the native prefetch ring; both decoders are timed on its
   files, and must agree.

11. depth engines (plain PyTorch on the card, no kernel of their own) on
   frame 0 of the bench: SGBM at SGBMConfig(), with and without speckle,
   equal to the CPU bit for bit, timed at one frame (CUDA events behind
   the spin, and unspun; kernel launches by torch.profiler; peak memory)
   and on a 30-frame chunk (its memory groups); LK stereo over CAPACITY
   points (frame 0's keypoints, 6 levels) against the CPU (status equal
   on at least 99.5 %, x within 1e-3 px), timed; the integer
   rectification warp at the reference calibration's 640x480 equal to
   the CPU, timed;
12. SGBM main path: run_staged over the 120 frames in
   SlamConfig(depth_method="sgbm") with a Mapper, every counter reset
   just before; assert K2, K3, K4 and K6 launched, K1 and K5 not, no
   plain version, a node per frame, bench.py:240's gates and ATE within
   its bound; print fps and peak memory;
13. realtime app (cli/slam_realtime.py) over phase 10's sequence: with
   "bm", pipelined, with asynchronous and then synchronous loop closure,
   its VO poses equal slam_batch.run's on the same RANSAC draws (fps,
   latency p50/p95 of each); then "sgbm" and "lk" (the
   latter with telemetry on: published and dropped frames, latest.json):
   0 lost, a loop closure, ATE within its bound, K2 and K3 once per
   frame, K1 and K5 never, no plain version;
14. the pose graph's device back end (optim/device.py, kernel K7
   csrc/thomas.cu, the block-Thomas solve): the batch app with
   -device-opt over phase 10's sequence, cut after frame 29 with a
   checkpoint and resumed to the end; (b) the resumed run's Mapper ids,
   poses, links, word count, node words and VO poses equal phase 10's
   straight run bit for bit, and the replay (cli/optimize_replay.py) of
   its map CSVs equals its optimized_poses.csv (atol 1e-3, the CSV round
   trip); (a) in the resumed run, counters reset just before it, K7 at
   least once per LM iteration and no plain solve; its optimized poses
   within translations 5e-2 and chi2 10 % of the host back end on the
   same graph, "device-dense" and "device" within chi2 2e-3 and
   translations 2e-2, ATE within PF_ATE_BOUND_M; each back end's host
   wall; K7 held to its plain version bit for bit on the first input
   the resumed run gave it, the main path's own shape (~60 vertices x 1 +
   12 R columns, R the Woodbury extras), timed spun and unspun, its
   forward and backward passes apart (tpuslam_thomas_stage), beside the
   plain version, the dense torch.linalg.solve of the same system and
   its chain bound from its SASS (tools/sass_chain.py): the numbers of
   K7's row; (c) a KITTI-00-sized graph (4541 vertices) with odometry
   noise, revisit loop closures, one forward closure and one gross
   outlier: run_optimize_robust on the host and twice with
   backend="device" (the two bit for bit: the assembly sums in one
   order), the wall of each, rounds, chi2, the largest translation
   difference, the outlier gone; then K7 held to its plain version bit
   for bit on the first lambda's system of a 1000-vertex cut and timed
   as in (a) at 1000 and 4541 vertices (the dense solve of the whole
   graph's 27240^2 system ~3 GB; the plain version not run there) (the
   row's `at_cut` and `at_4541`); with --parent DIR (a parent's tree,
   unpacked), K7 (tools/thomas_probe.py) and the 4541-vertex device back
   end (tools/backend_turns.py) in turns with the parent's;
15. the tool apps, each with every counter reset just before it: (a)
   cli/kernel_test.py on the golden pair (all_pass, 0 golden mismatches,
   K1, K5 and K2 once, the report and the disparity equal to the CPU
   run's); (b) cli/hw_test.py's 9dof, patterns and timing each exit 0,
   patterns launching K1, K5, K2 and K3's blur (dist/mesh.py's
   frontend_one) once per pattern, its outputs equal to the CPU's, and
   the device round trip; (c) cli/stereo_capture.py -source synthetic
   -frontend over 10 frames (the KITTI layout, the seven dump hooks'
   files for every frame, keypoints in each, K1, K5 and K3 once per frame
   and K2 twice); (d) cli/stereo_calib.py over 8 rendered views of
   tests/test_calib.py's rig on the card and on the CPU (the JAX suite's
   gates, the card within tests/test_torch_calib.py's tolerances of the
   CPU, both walls); (e) the main path (run_staged, chunk 20, no Mapper)
   on tests/test_real_texture.py's 120-frame world textured with the
   fixture's real frame, rendered on the card (0 lost, t_err < 1.5 %, ATE
   < 1.5 m, K1-K6 launched).  Each kernel row's `tool_apps` holds its
   launches in (a), (b), (c) and (e).
16. the multi-device layer (dist/), each part with every counter reset
   just before it: (a) sharded_frontend_step on 4 shards of the card
   over the bench's first 8 frames, speckle off and on: K1, K5, K2 and
   K3's blur once per shard, no plain version, every frame bit for bit
   frontend_one's, and a mesh of 1 and of 4 timed in turns (the sharding
   efficiency t(mesh 1) / t(mesh 4)); (b) the sharded dense and sparse
   pose-graph steps (K7 once per iteration, the root solve on global
   shard 0) on a 200-vertex noisy loop with a forward closure, and the
   sharded BA, against lm_solve, lm_solve_sparse and ba_solve on the
   card within the JAX suite's tolerances, each timed warm; (c)
   tools/dist_worker.py as two gloo ranks sharing the card, as one
   process, and cli/slam_multihost.py as two gloo ranks, five processes
   at once over phase 10's sequence: the ranks equal each other, the VO
   poses and the partitioned map the one process's and the
   single-process Mapper's bit for bit, the words split by parity, loop
   closures, K7 on rank 0 only, the dictionary top-2 on the global mesh,
   no worker building a kernel, each process's wall and map bytes; (d)
   one NCCL rank running (b)'s steps with their collectives through
   NCCL, equal to (b)'s, and two NCCL ranks on the one card (NCCL
   refuses them: "Duplicate GPU detected", printed).  Each kernel row's
   `dist` holds its launches in (a), (b), (c)'s two ranks and its one
   process.

With --spread N the main path, the per-frame path, the SGBM main path,
the realtime app's sgbm and lk runs and phase 15's real-texture main path
are run again with RANSAC seeds 1..N and the quality of each is printed
(the data behind PERF.md's ATE bounds).

Prints fps, inliers, ATE and KITTI errors, one JSON line of per-kernel
numbers (the harness's row with its per-phase numbers under "phases"; the
per-frame path's under "per_frame" and, for K6, "per_frame_loop_closure"),
the nvidia-smi line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import functools
import json
import math
import subprocess
import sys
import tempfile
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
# the per-frame batch path: an out-and-back sequence over the bench's
# camera (tpuslam_torch.io.synthetic.out_and_back_trajectory), 2 * 30 + 1
# frames; the Mapper of tests/test_slam_e2e.py:25-27 (a full node every 2
# frames, 3 in short-term memory), since the default one (30) holds every
# node of 61 frames in short-term memory and so closes no loop
PF_FORWARD, PF_SPEED, PF_SEED, PF_WARM_FRAMES = 30, 0.45, 7, 4
PF_MAP_UPDATE, PF_MAX_STM = 2, 3
# ATE bound of the per-frame path: tpuslam's own run of these poses on
# the CPU reads 0.0270 m; the port over six RANSAC seed sets on the card
# 0.0199-0.0280 m (PERF.md "End-to-end metrics"); 1.33x the worst
PF_ATE_BOUND_M = 0.037
PF_OUTPUTS = ("map_poses.csv", "map_links.csv", "optimized_poses.csv",
              "slam.bt", "perf_time.csv")
PF_SPANS = ("captureImageLR", "frontend", "odom.process", "mapper.process")
# timed runs of each of run_staged and run_ingest in the ingest phase, in
# turns: the host-bound path's fps spreads from run to run in one call
INGEST_TURNS = 3
# K6 against its plain version: f32 reduction order (tests/test_pnp.py)
LM_TOL = dict(rvec=1e-5, tvec=1e-4, inlier_px=2.0)
# the other depth engines.  LK on the card against the CPU: the least
# share of equal statuses and the x tolerance where both tracked
LK_STATUS_MIN, LK_X_TOL = 0.995, 1e-3
# ATE bounds, 1.33x the worst RANSAC seed of a --spread on the card
# (PERF.md "End-to-end metrics": the SGBM main path 0.3635-0.4398 m over
# six seeds, the realtime app's sgbm 0.0237-0.0247 m and lk
# 0.0026-0.0077 m over six seed sets); tpuslam on a CPU reads:
# the main path with SGBM 0.3378 m (0 lost, median inliers 482, t_err
# 0.360 %), the realtime app over the per-frame sequence with SGBM
# 0.0243 m and with LK 0.0050 m (0 lost, 14 loop closures each)
SGBM_ATE_BOUND_M = 0.585
RT_ATE_BOUND_M = {"sgbm": 0.033, "lk": 0.0103}


# the back-end phase's graph at a size users run (KITTI odometry sequence
# 00's 4541 frames) and its 1000-vertex cut: tools/thomas_probe.py
# BE_CUT; K7 is held to its plain version bit for bit (tolerance 0)
BE_CHECKPOINT = 30      # frames 0-29, then a resume (phase 14b)
# host vs device back end (f32 vs f64): tests/test_dist.py:124-125;
# device vs device-dense: tests/test_dist.py:172-175
BE_HOST_TOL = dict(t=5e-2, chi2=0.1)
BE_DENSE_TOL = dict(t=2e-2, chi2=2e-3)
# cuobjdump's text of 2^100, the scaling of K7's rare path (div_small)
K7_RARE = "1.2676506002282294"


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


def hold(name, kernel, plain, outs_k, outs_p, nbytes, ops, tol=0.0,
         what=""):
    """Hold a kernel's outputs to its plain version's within `tol` and time
    both (spun; the kernel also unspun).  Returns the numbers of a
    kernel's row."""
    from tpuslam_torch.tools.timing import bound, call_ms, time_ms
    err = max(max_abs_err(k, p) for k, p in zip(outs_k, outs_p))
    if not err <= tol:
        raise AssertionError(f"{name}{what}: kernel differs from plain "
                             f"version (max abs err {err} > {tol})")
    b_ms, b_by = bound(nbytes, ops)
    row = dict(max_abs_err=err, ms=time_ms(kernel), call_ms=call_ms(kernel),
               plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by)
    log(f"# {name}{what}: max abs err {err} (tolerance {tol}); kernel "
        f"{row['ms']:.4f} ms (unspun {row['call_ms']:.4f} ms), plain "
        f"{row['plain_ms']:.3f} ms, bound {b_ms:.5f} ms ({b_by})")
    return row


def record(rows, name, src, replaces, kernel, plain, outs_k, outs_p,
           nbytes, ops, tol=0.0):
    """hold() a kernel at the main path's shapes and add its row to
    `rows`."""
    rows[name] = dict(name=name, route="cuda", source=src,
                      replaces=replaces, library_ms=None,
                      **hold(name, kernel, plain, outs_k, outs_p, nbytes,
                             ops, tol))


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

    # K1 (its packed kernel): disparity and min-SAD of 30 frames.  Bound:
    # the pair in (2 B), int16 disparity and int32 min-SAD out (6 B) per
    # pixel; per pixel and disparity an absolute difference, two
    # running-sum updates per box direction and a compare (6 operations)
    kb = BM.stereo_bm_cuda(lefts, rights, cfg.bm)
    pb = BM.stereo_bm_plain(lefts, rights, cfg.bm)
    record(rows, "stereo_bm", "tpuslam_torch/csrc/stereo_bm.cu",
           "tpuslam/kernels/stereo_bm_pallas.py:423",
           lambda: BM.stereo_bm_cuda(lefts, rights, cfg.bm),
           lambda: BM.stereo_bm_plain(lefts, rights, cfg.bm), kb, pb,
           8 * px, 6 * cfg.bm.num_disparities * px)
    valid_px = float((pb[0] >= 0).float().mean())
    shape = BM.stereo_bm_packed_shape(cfg.bm)
    rows["stereo_bm"]["shape"] = shape
    log(f"# stereo_bm: {valid_px:.3f} of pixels hold a disparity; packed "
        f"kernel, a {shape['columns']} x {shape['rows']} tile a block "
        f"({shape['sub_bands']} sub-bands of 8 rows), "
        f"{shape['registers']} registers, {shape['shared_bytes']} B shared "
        f"memory, {shape['blocks_per_sm']} blocks of 256 threads per SM")

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


# configurations outside K1's packed kernel, which K1 runs in its wide
# kernel (the reference's strip kernel takes each): StereoBMConfig keywords
# and the frames of the chunk it runs on
K1_WIDE = {"ndisp1": (dict(num_disparities=1), 1),
           "ndisp32": (dict(num_disparities=32), 1),
           "ndisp80": (dict(num_disparities=80), 1),
           "block33": (dict(prefilter_cap=15, block_size=33), 1),
           "block51": (dict(prefilter_cap=31, block_size=51), 1),
           "cost": (dict(prefilter_cap=63, block_size=23), 1),
           "ndisp128": (dict(num_disparities=128, min_disparity=-5), CHUNK)}


def k1_wide_phase(rows, lefts, rights):
    """K1's wide kernel at each K1_WIDE configuration, on the first frame
    of the chunk or the whole chunk, held bit for bit to its plain twin on
    the card and timed (a main-path run never launches it), with its
    launch shape and occupancy.  Bound as K1's: the pair in, disparity
    and min-SAD out (8 B a pixel), 6 operations per pixel and
    disparity."""
    from tpuslam_torch.config import StereoBMConfig
    from tpuslam_torch.kernels import stereo_bm as BM
    wide = {}
    for case, (kw, frames) in K1_WIDE.items():
        cfg = StereoBMConfig(**kw)
        if BM.k1_packed_refusal(cfg) is None:
            raise AssertionError(f"K1 wide, {case}: the packed kernel "
                                 f"takes it")
        lb, rb = lefts[:frames].contiguous(), rights[:frames].contiguous()
        px = lb.numel()
        nbytes, ops = 8 * px, 6 * cfg.num_disparities * px
        wide[case] = dict(hold(
            "stereo_bm", lambda: BM.stereo_bm_cuda(lb, rb, cfg),
            lambda: BM.stereo_bm_plain(lb, rb, cfg),
            BM.stereo_bm_cuda(lb, rb, cfg), BM.stereo_bm_plain(lb, rb, cfg),
            nbytes, ops, what=f" (wide kernel, {case}, {frames} frames)"),
            frames=frames, bytes=nbytes, ops=ops,
            shape=BM.stereo_bm_wide_shape(cfg))
        log(f"# stereo_bm wide kernel, {case}: {wide[case]['shape']}")
    rows["stereo_bm"]["wide"] = wide


def lm_check(args, what):
    """K6 against its plain version on one argument list, to LM_TOL.
    Returns the kernel's and the plain version's (rvec, tvec)."""
    from tpuslam_torch.kernels import pnp as P
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


def hold_lm(args, what):
    """lm_check() and hold() K6 on one argument list.  Bound: per point
    obj, img, weight, valid in and the error out (29 B); 21 evaluations
    of ~150 operations per point."""
    from tpuslam_torch.kernels import pnp as P
    args = [a.contiguous() for a in args]
    n_c = len(args[0])
    outs_k, outs_p = lm_check(args, what)
    return hold("lm_refine", lambda: P.refine_lm_errors_cuda(*args),
                lambda: P.refine_lm_with_errors(*args), outs_k, outs_p,
                29 * n_c, 21 * 150 * n_c, tol=LM_TOL["tvec"],
                what=f" ({what}, N = {n_c})")


def lm_phase(rows, frame1_args, camera, cfg):
    """K6, the LM refine, against its plain version to LM_TOL: on the
    arguments the main path's VO step gave it at frame 1 (timed), and on a
    scene with a known pose."""
    from tpuslam_torch.io.synthetic import pnp_scene
    scene, rv_true, tv_true = pnp_scene(np.random.default_rng(SEED),
                                        CAPACITY, camera.K_l)
    (kr, kt), _ = lm_check(scene, "known pose")
    if not (np.abs(kr.cpu().numpy() - rv_true).max() < 2e-3 and
            np.abs(kt.cpu().numpy() - tv_true).max() < 2e-2):
        raise AssertionError("lm_refine: known pose not recovered")
    if not float(frame1_args[2].sum()) >= cfg.pnp.min_inliers:
        raise AssertionError("lm_refine: the recorded frame-1 call has "
                             "too few weighted rows")
    rows["lm_refine"] = dict(
        name="lm_refine", route="cuda",
        source="tpuslam_torch/csrc/lm_refine.cu",
        replaces="tpuslam/kernels/pnp.py:1067", library_ms=None,
        **hold_lm(frame1_args, "main path, frame 1"))


def quality(infos, gt):
    est = np.stack([i.pose for i in infos])
    if len(infos) != len(gt) or not np.isfinite(est).all():
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
    return q, N_FRAMES / dt, launches, plain, mp, calls, infos


def main_path_phase(camera, cfg, staged, items, gt):
    """bench.py's run: SlamConfig() with a Mapper (async LC, device
    dictionary)."""
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    pipe = FastSlamPipeline(camera, cfg, chunk=CHUNK, capacity=CAPACITY,
                            seed=SEED)
    q, fps, launches, plain, mapper, calls, infos = timed_run(
        pipe, staged, items, gt, "main path", with_mapper=True, n_record=2)
    check_bench_run("main path", q, launches, plain, mapper)
    # the VO step refines once per frame: call 1 is frame 1's
    return mapper, launches, fps, calls[1], infos


def check_bench_run(what, q, launches, plain, mapper):
    """bench.py's run: every kernel of the main path launched, no plain
    version and no tool, a Mapper node per frame and words, bench.py:240's
    gates and ATE within ATE_BOUND_M."""
    from tpuslam_torch.kernels import _cuda
    missing = [k for k in _cuda.KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {what}: "
                             f"{missing}")
    if any(v != 0 for v in plain.values()):
        raise AssertionError(f"{what}: a plain version ran: {plain}")
    if any(launches[k] != 0 for k in _cuda.TOOLS):
        raise AssertionError(f"a tool ran on the {what}: {launches}")
    log(f"# {what}: mapper {len(mapper.nodes)} nodes, {mapper.vwd._count} "
        f"words, {len(mapper.loop_closures)} loop closures")
    if len(mapper.nodes) != N_FRAMES or not mapper.vwd._count > 0:
        raise AssertionError(f"{what}: the Mapper lacks a node per frame or "
                             f"words")
    if q["lost"] > MAX_LOST or q["median_inliers"] < MIN_MEDIAN_INLIERS \
            or not q["t_err"] <= MAX_T_ERR_PCT:
        raise AssertionError(f"{what}: bench gates failed: {fmt(q)}")
    if not q["ate"] <= ATE_BOUND_M:
        raise AssertionError(f"{what}: ATE {q['ate']} m above the bound "
                             f"{ATE_BOUND_M} m")


def write_pngs(paths_imgs, row_filter=None):
    """Write each (path, (H, W) uint8 image) as a PNG (rows filtered as
    io/png.py's encoder says) on 8 threads (zlib and numpy release the
    GIL); returns the seconds taken."""
    from concurrent.futures import ThreadPoolExecutor
    from tpuslam_torch.io import png
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda pi: png.write_png(*pi, row_filter=row_filter),
                      paths_imgs))
    return time.perf_counter() - t0


def decode_ms(paths):
    """Median ms per image of the native decoder (tsl_decode) and of
    io/png.py's Python decoder over the files `paths` (host CPU), which
    must decode each file alike.  Returns the medians and the images."""
    import statistics
    from tpuslam_torch.io import png
    from tpuslam_torch.io.native_loader import decode_image
    ms, images = {"native": [], "python": []}, []
    for p in paths:
        got = {}
        for name, fn in (("native", decode_image), ("python", png.read_png)):
            t0 = time.perf_counter()
            got[name] = fn(p)
            ms[name].append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(got["native"], got["python"]):
            raise AssertionError(f"PNG: the decoders differ on {p}")
        images.append(got["python"])
    return {k: statistics.median(v) for k, v in ms.items()}, images


def ingest_phase(workdir, camera, cfg, lefts, rights, stamps, gt, staged,
                 items, staged_infos, staged_fps):
    """bench.py's ingest pass (bench.py:139-190): the bench sequence's
    frames written as PNGs (rows filtered as libpng filters them), then
    FastSlamPipeline.run_ingest with an async Mapper from those files, once
    warm and once timed, every counter reset just before the timed run;
    assert what main_path_phase asserts, and that every frame the loop
    uploaded equals the rendered one; print ingest fps beside the staged
    fps, the pure host-to-device ceiling of the same bytes from pinned
    memory and ingest_efficiency, the decode ms per image of both decoders
    at the written mix and with every row Paeth, and the largest pose
    difference to run_staged's run.  Then INGEST_TURNS - 1 more pairs of
    timed runs (staged, ingest), so that the two alternate after
    main_path_phase's staged run, and the medians of each."""
    import os
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.mapping.mapper import Mapper
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline

    seq = os.path.join(workdir, "bench_seq")
    host = (lefts.cpu().numpy(), rights.cpu().numpy())
    paths = []
    for sub, imgs in zip(("image_0", "image_1"), host):
        os.makedirs(os.path.join(seq, sub))
        paths.append([os.path.join(seq, sub, f"{i:06d}.png")
                      for i in range(N_FRAMES)])
    took = write_pngs([(p, img) for ps, imgs in zip(paths, host)
                       for p, img in zip(ps, imgs)])
    log(f"# ingest: wrote {2 * N_FRAMES} PNGs of {WIDTH}x{HEIGHT} in "
        f"{took:.2f} s (8 host threads)")
    paeth = [os.path.join(workdir, f"paeth{i}.png") for i in range(20)]
    write_pngs([(p, host[i % 2][i // 2]) for i, p in enumerate(paeth)],
               row_filter=4)
    dec = decode_ms(paths[0][:20] + paths[1][:20])[0]
    dec_paeth = decode_ms(paeth)[0]
    log(f"# ingest: decode ms per {WIDTH}x{HEIGHT} image (median of 40 / "
        f"20, host CPU): native {dec['native']:.3f} / "
        f"{dec_paeth['native']:.3f}, Python {dec['python']:.3f} / "
        f"{dec_paeth['python']:.3f} (the written mix / every row Paeth)")

    pipe = FastSlamPipeline(camera, cfg, chunk=CHUNK, capacity=CAPACITY,
                            seed=SEED)
    seen = []
    dispatch = pipe.dispatch

    def recording(lb, rb, st, n):
        # copies on the compute stream, after the uploads it waits for:
        # what the chunk computes on
        seen.append((torch.as_tensor(lb[:n]).clone(),
                     torch.as_tensor(rb[:n]).clone()))
        return dispatch(lb, rb, st, n)

    pipe.dispatch = recording

    def run():
        seen.clear()
        pipe.reset()
        mp = Mapper(camera, cfg.mapper, cfg.matching, cfg.pnp)
        mp.async_lc = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infos = pipe.run_ingest(*paths, stamps, mapper=mp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = [torch.cat([s[k].to("cuda") for s in seen]) for k in (0, 1)]
        if not (torch.equal(got[0], lefts) and torch.equal(got[1], rights)):
            raise AssertionError("ingest: a frame the loop uploaded differs "
                                 "from the rendered one")
        return infos, dt, mp

    _, dt, _ = run()
    log(f"# ingest: warm run {dt:.2f} s")
    _cuda.reset_counters()
    infos, dt, mapper = run()
    launches, plain = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
    q = quality(infos, gt)
    fps = N_FRAMES / dt
    log(f"# ingest: {N_FRAMES} frames {WIDTH}x{HEIGHT} from PNG files in "
        f"{dt:.3f} s = {fps:.3f} fps (staged, same call: {staged_fps:.3f} "
        f"fps); {fmt(q)}; every uploaded frame equals the rendered one")
    log(f"# ingest: launches {launches}, plain calls {plain}")
    check_bench_run("ingest path", q, launches, plain, mapper)

    # the link's ceiling: the same bytes uploaded chunk by chunk from
    # pinned memory, nothing decoded or computed
    pinned = [torch.from_numpy(h).pin_memory() for h in host]
    sink = [p[:CHUNK].to("cuda", non_blocking=True) for p in pinned]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sink = [p[lo:lo + CHUNK].to("cuda", non_blocking=True)
            for lo in range(0, N_FRAMES, CHUNK) for p in pinned]
    torch.cuda.synchronize()
    ceiling_fps = N_FRAMES / (time.perf_counter() - t0)
    del sink
    nbytes = sum(h.nbytes for h in host)
    log(f"# ingest: pure host-to-device ceiling {ceiling_fps:.1f} fps "
        f"({nbytes / 1e6:.1f} MB from pinned memory, "
        f"{nbytes / 1e9 * ceiling_fps / N_FRAMES:.2f} GB/s); "
        f"ingest_efficiency {min(1.0, fps / ceiling_fps):.6f}")
    diff = max(float(np.abs(a.pose - b.pose).max())
               for a, b in zip(infos, staged_infos))
    log(f"# ingest: largest pose difference to run_staged's timed run "
        f"{diff:.3g} (same frames, same seed)")

    turns = {"staged": [staged_fps], "ingest": [fps]}
    for _ in range(INGEST_TURNS - 1):
        pipe.reset()
        mp = Mapper(camera, cfg.mapper, cfg.matching, cfg.pnp)
        mp.async_lc = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run_staged(staged, items, mapper=mp, mapper_async=True)
        torch.cuda.synchronize()
        turns["staged"].append(N_FRAMES / (time.perf_counter() - t0))
        turns["ingest"].append(N_FRAMES / run()[1])
    med = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}
    log("# ingest: fps in turns (staged, ingest, ...) " + ", ".join(
        f"{a:.3f}, {b:.3f}" for a, b in zip(turns["staged"],
                                            turns["ingest"])) +
        f"; medians staged {med['staged']:.3f}, ingest {med['ingest']:.3f}"
        f", ingest / staged {med['ingest'] / med['staged']:.4f}")
    return fps


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
    # global BA again on the same input: its sums take one order (C7)
    ba_again = refine_trajectory_global_ba(mapper, optimized, camera)
    if sorted(ba_again) != sorted(ba_poses) or not all(
            np.array_equal(ba_again[k], ba_poses[k]) for k in ba_poses):
        raise AssertionError("global BA: two runs on the same input differ")
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
        f"{t2 - t1:.2f} s (host wall); global BA run twice: bit for bit")


def slice_phase(camera, staged, items, gt):
    """The first slice's path: no LR check, no LM refine, no Mapper."""
    from tpuslam_torch.config import SlamConfig, StereoBMConfig, PnPConfig
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    cfg = SlamConfig().replace(bm=StereoBMConfig(disp12_max_diff=-1),
                               pnp=PnPConfig(refine_iterations=0))
    pipe = FastSlamPipeline(camera, cfg, chunk=CHUNK, capacity=CAPACITY,
                            seed=SEED)
    q, fps, launches, plain, _, _, _ = timed_run(
        pipe, staged, items, gt, "slice path", with_mapper=False)
    need = ("stereo_bm", "gftt", "orb", "median")
    if any(launches[k] == 0 for k in need) or any(plain.values()):
        raise AssertionError(f"slice path: launches {launches}, plain "
                             f"{plain}")
    if q["lost"] > MAX_LOST or not q["ate"] <= SLICE_ATE_BOUND_M:
        raise AssertionError(f"slice path quality: {fmt(q)}")
    return fps


def pf_config():
    from tpuslam_torch.config import MapperConfig, SlamConfig
    return SlamConfig().replace(mapper=MapperConfig(
        map_update=PF_MAP_UPDATE, max_stm_size=PF_MAX_STM))


def pf_draws(k):
    """RANSAC uniforms of seed set k for every registration (seed ->
    (300, 6)); None (k = 0) keeps the path's own generator."""
    if k == 0:
        return None
    return lambda seed: np.random.default_rng((k, seed)).random(
        (300, 6), dtype=np.float32)


def span_totals(path):
    """The perf_time.csv column totals (ms) of PF_SPANS."""
    with open(path) as f:
        names = f.readline().strip().split(",")[1:]
        rows = [[float(v) for v in line.strip().split(",")[1:]]
                for line in f if line.strip()]
    return {n: sum(r[i] for r in rows) for i, n in enumerate(names)
            if n in PF_SPANS}


def speckle_check(lefts, rights, cfg):
    """The speckle filter on the card against the same function on the
    CPU, bit for bit: one frame's disparity and a 30-frame batch; returns
    the card's ms for one frame (unspun: it reads its convergence check on
    the host) and the 30-frame batch."""
    from tpuslam_torch.kernels import stereo_bm as BM
    from tpuslam_torch.tools.timing import call_ms
    bm = cfg.bm
    disp = BM.stereo_bm_lr(lefts, rights, bm)
    args = (bm.speckle_window_size, bm.speckle_range,
            (bm.min_disparity - 1) * 16)
    one = BM.speckle_filter(disp[0], *args)
    one_cpu = BM.speckle_filter(disp[0].cpu(), *args)
    batch = BM.speckle_filter_batch(disp, *args)
    batch_cpu = BM.speckle_filter_batch(disp.cpu(), *args)
    if not (torch.equal(one.cpu(), one_cpu) and
            torch.equal(batch.cpu(), batch_cpu)):
        raise AssertionError("speckle: the card differs from the CPU")
    removed = int(((batch != disp) & (batch == args[2])).sum())
    frame_ms = call_ms(lambda: BM.speckle_filter(disp[0], *args),
                       runs=5)
    batch_ms = call_ms(lambda: BM.speckle_filter_batch(disp, *args), runs=3)
    log(f"# speckle: card == CPU bit for bit (1 frame, {len(disp)}-frame "
        f"batch; {removed} pixels filtered in the batch); card {frame_ms:.3f}"
        f" ms per frame, {batch_ms:.3f} ms per {len(disp)}-frame batch "
        f"(unspun, its host reads included)")
    return frame_ms, batch_ms


def pf_kernel_phase(rows, frame, vo_args, lc_args, cfg):
    """K1, K5, K2, K3 and K6 against their plain versions on the card at
    the per-frame path's shapes, each timed into its row under
    "per_frame": frame 0 of the timed run as one (1, H, W) pair, its
    border-filtered keypoints padded to CAPACITY, and the first LM-refine
    call of the odometry and of the loop closure.  The kernels also
    reproduce that frame's speckled disparity and descriptors of the run.
    Bounds as in kernel_phase and lm_phase."""
    from tpuslam_torch.kernels import stereo_bm as BM, gftt as G, orb as O
    left, right = (torch.as_tensor(frame[k], device="cuda")[None]
                   for k in ("left", "right"))
    _, H, W = left.shape
    px = H * W
    out, bm = {}, cfg.bm
    kb = BM.stereo_bm_cuda(left, right, bm)
    pb = BM.stereo_bm_plain(left, right, bm)
    out["stereo_bm"] = hold(
        "stereo_bm", lambda: BM.stereo_bm_cuda(left, right, bm),
        lambda: BM.stereo_bm_plain(left, right, bm), kb, pb, 8 * px,
        6 * bm.num_disparities * px, what=" (per frame)")
    kl = BM.lr_check_cuda(*kb, bm)
    pl = BM.lr_check_plain(*pb, bm)
    out["lr_check"] = hold(
        "lr_check", lambda: BM.lr_check_cuda(*kb, bm),
        lambda: BM.lr_check_plain(*pb, bm), (kl,), (pl,), 8 * px, 20 * px,
        what=" (per frame)")
    if not np.array_equal(BM.speckle_bm(kl, bm)[0].cpu().numpy(),
                          frame["disparity"]):
        raise AssertionError("per-frame kernels: frame 0's disparity "
                             "differs from the run's")
    ke, kd = G.gftt_response_dil_cuda(left)
    pe, pd = G.gftt_response_dil_plain(left)
    out["gftt"] = hold(
        "gftt", lambda: G.gftt_response_dil_cuda(left),
        lambda: G.gftt_response_dil_plain(left),
        (ke.view(torch.int32), kd), (pe.view(torch.int32), pd), 9 * px,
        40 * px, what=" (per frame)")
    n = len(frame["kpts"])
    xy = np.zeros((1, CAPACITY, 2), np.float32)
    xy[0, :n] = frame["kpts"][:, :2]
    kp = torch.as_tensor(xy, device="cuda")
    valid = torch.arange(CAPACITY, device="cuda")[None] < n
    kdsc = O.orb_descriptors_cuda(left, kp, valid)
    pdsc = O.orb_descriptors_plain(left, kp, valid)
    out["orb"] = hold(
        "orb", lambda: O.orb_descriptors_cuda(left, kp, valid),
        lambda: O.orb_descriptors_plain(left, kp, valid), (kdsc,), (pdsc,),
        px + 40 * n, 28 * px + 256 * n, what=f" (per frame, {n} keypoints)")
    if not np.array_equal(kdsc[0, :n].cpu().numpy(), frame["desc"]):
        raise AssertionError("per-frame kernels: frame 0's descriptors "
                             "differ from the run's")
    out["lm_refine"] = hold_lm(vo_args, "per-frame odometry, first call")
    for k, v in out.items():
        rows[k]["per_frame"] = v
    rows["lm_refine"]["per_frame_loop_closure"] = hold_lm(
        lc_args, "per-frame loop closure, first call")


def per_frame_phase(workdir, rows):
    """The batch app (cli/slam_batch.py) over a written out-and-back
    sequence: a warm run of a few frames, then every counter reset and a
    timed run of all of them; then pf_kernel_phase on what the timed run
    gave the kernels."""
    import os
    from tpuslam_torch.cli import slam_batch
    from tpuslam_torch.io import png
    from tpuslam_torch.io.synthetic import out_and_back_trajectory, \
        write_sequence
    from tpuslam_torch.kernels import _cuda, pnp as P, stereo_bm as BM
    from tpuslam_torch.mapping import mapper as M
    from tpuslam_torch.vo import odometry as O

    seq = os.path.join(workdir, "seq")
    poses = out_and_back_trajectory(PF_FORWARD, PF_SPEED)
    n = len(poses)
    t0 = time.perf_counter()
    write_sequence(seq, width=WIDTH, height=HEIGHT, f=FOCAL,
                   baseline=BASELINE, poses=poses, seed=PF_SEED)
    log(f"# per-frame path: wrote {n} stereo pairs (rendered on the card, "
        f"PNG-encoded) in {time.perf_counter() - t0:.2f} s")
    files = [os.path.join(seq, d, f) for d in ("image_0", "image_1")
             for f in sorted(os.listdir(os.path.join(seq, d)))]
    mix = np.zeros(5, np.int64)
    for path in files:
        with open(path, "rb") as f:
            mix += np.bincount(png.row_filters(f.read()), minlength=5)
    dec, decoded = decode_ms(files)
    images = {os.path.relpath(p, seq): img for p, img in zip(files, decoded)}
    log(f"# per-frame path: PNG decode per {WIDTH}x{HEIGHT} image (median "
        f"of {len(files)}; host CPU): native {dec['native']:.3f} ms (the "
        f"path's reader), Python {dec['python']:.3f} ms; the two equal; row "
        f"filters None/Sub/Up/Average/Paeth "
        f"{'/'.join(str(int(v)) for v in mix)} (chosen per row as libpng "
        f"and Pillow choose)")

    cfg = pf_config()
    t0 = time.perf_counter()
    slam_batch.run(seq, cfg, num_images=PF_WARM_FRAMES - 1, quiet=True,
                   out_dir=os.path.join(workdir, "warm"))
    log(f"# per-frame path: warm run of {PF_WARM_FRAMES} frames "
        f"{time.perf_counter() - t0:.2f} s")

    # the odometry's and the loop closure's registrations (calls, K6
    # launches, host ms: each ends in host reads of its result), the
    # arguments of each kind's first LM-refine call, frame 0's inputs and
    # outputs, and each frame's OdomInfo
    orig, process, infos = O.compute_transform, O.Odometry.process, []
    auto, refine_args, now, frame0 = P.refine_lm_with_errors_auto, {}, \
        [None], {}
    reg = {"vo": [0, 0, 0.0], "lc": [0, 0, 0.0]}

    def counted(kind):
        def call(*args, **kw):
            before = _cuda.LAUNCHES["lm_refine"]
            t0 = time.perf_counter()
            now[0] = kind
            try:
                out = orig(*args, **kw)
            finally:
                now[0] = None
            r = reg[kind]
            r[0] += 1
            r[1] += _cuda.LAUNCHES["lm_refine"] - before
            r[2] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    def recording(*args):
        if now[0] is not None and now[0] not in refine_args:
            refine_args[now[0]] = [a.clone() for a in args]
        return auto(*args)

    def recorded(self, frame):
        if not frame0:
            frame0.update(left=frame.image_left.copy(),
                          right=frame.image_right.copy(),
                          disparity=frame.disparity.copy(),
                          kpts=frame.kpts.copy(), desc=frame.desc.copy())
        infos.append(process(self, frame))
        return infos[-1]

    out = os.path.join(workdir, "out")
    O.compute_transform, O.Odometry.process = counted("vo"), recorded
    M.compute_transform = counted("lc")
    P.refine_lm_with_errors_auto = recording
    try:
        BM.SPECKLE_ROUNDS.clear()
        _cuda.reset_counters()
        torch.cuda.synchronize()
        res = slam_batch.run(seq, cfg, quiet=True, out_dir=out)
        torch.cuda.synchronize()
    finally:
        O.compute_transform, O.Odometry.process = orig, process
        M.compute_transform = orig
        P.refine_lm_with_errors_auto = auto
    vo = reg["vo"]
    launches, plain = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
    rounds = sorted(BM.SPECKLE_ROUNDS)
    spans = span_totals(os.path.join(out, "perf_time.csv"))
    log(f"# per-frame path: {n} frames {WIDTH}x{HEIGHT} at "
        f"{res['fps']:.3f} fps (run()'s own); "
        f"{res['n_nodes']} nodes, {res['n_links']} links, "
        f"{res['n_loop_closures']} loop closures, "
        f"{res['n_occupied_voxels']} occupied voxels")
    log(f"# per-frame path: ATE={res['ate_m']:.4f} m, "
        f"t_err={res['t_err_pct']:.4f} %, "
        f"r_err={res['r_err_deg_per_m']:.6f} deg/m (optimized poses)")
    log("# per-frame path: span totals " + ", ".join(
        f"{k} {spans.get(k, 0.0):.1f} ms ({spans.get(k, 0.0) / n:.2f} ms "
        f"per frame)" for k in PF_SPANS))
    log(f"# per-frame path: speckle rounds per frame median "
        f"{rounds[len(rounds) // 2]}, max {rounds[-1]} (checked every "
        f"{BM.SPECKLE_CHECK_EVERY})")
    for kind, what in (("vo", "odometry"), ("lc", "loop-closure")):
        c, k6, ms = reg[kind]
        log(f"# per-frame path: {c} {what} registrations, K6 launched {k6} "
            f"times, {ms:.1f} ms host wall ({ms / max(c, 1):.2f} ms each)")
    log(f"# per-frame path: launches {launches}, plain calls {plain}")

    lost = sum(1 for i in infos if i.lost)
    inl = sorted(i.num_inliers for i in infos[1:])
    log(f"# per-frame path: lost {lost}, inliers median {inl[len(inl) // 2]}"
        f", min {inl[0]}; {sum(i.keyframe_added for i in infos)} keyframes")
    for k in ("stereo_bm", "lr_check", "gftt", "orb"):
        if launches[k] != n:
            raise AssertionError(f"per-frame path: {k} launched "
                                 f"{launches[k]} times, not once per frame")
    if not launches["lm_refine"] > vo[1]:
        raise AssertionError("per-frame path: K6 ran in no loop closure")
    if launches["median"] or any(launches[k] for k in _cuda.TOOLS) or \
            any(plain.values()):
        raise AssertionError(f"per-frame path: launches {launches}, plain "
                             f"{plain}")
    missing = [f for f in PF_OUTPUTS
               if not os.path.exists(os.path.join(out, f))]
    if res["n_nodes"] != n or res["n_loop_closures"] < 1 or lost or \
            missing or not res["n_occupied_voxels"] > 0:
        raise AssertionError(f"per-frame path: nodes {res['n_nodes']}, loop "
                             f"closures {res['n_loop_closures']}, lost {lost}"
                             f", missing {missing}")
    if not res["ate_m"] <= PF_ATE_BOUND_M:
        raise AssertionError(f"per-frame path: ATE {res['ate_m']} m above "
                             f"the bound {PF_ATE_BOUND_M} m")
    if set(refine_args) != {"vo", "lc"}:
        raise AssertionError(f"per-frame path: LM-refine calls recorded "
                             f"for {sorted(refine_args)} only")
    pf_kernel_phase(rows, frame0, refine_args["vo"], refine_args["lc"], cfg)
    pf_paeth_phase(seq, images, workdir, cfg, res)
    return seq, res, launches


def pf_paeth_phase(seq, images, workdir, cfg, first):
    """The per-frame path once more over the same images with every row
    Paeth-filtered, as Pillow and libpng filter most rows of a photograph
    (tests/test_torch_io.py's fixture image) and so KITTI's: fps at that
    decode cost.  The files decode to the same images; the run gives the
    same number of nodes and an ATE within the bound."""
    import os
    import shutil
    from tpuslam_torch.cli import slam_batch
    dst = os.path.join(workdir, "seq_paeth")
    shutil.copytree(seq, dst, ignore=shutil.ignore_patterns("*.png"))
    paths = [os.path.join(dst, rel) for rel in images]
    write_pngs(list(zip(paths, images.values())), row_filter=4)
    dec, decoded = decode_ms(paths)
    for rel, img, back in zip(images, images.values(), decoded):
        if not np.array_equal(back, img):
            raise AssertionError(f"PNG: {rel} Paeth-filtered decodes wrong")
    out = os.path.join(workdir, "out_paeth")
    res = slam_batch.run(dst, cfg, quiet=True, out_dir=out)
    spans = span_totals(os.path.join(out, "perf_time.csv"))
    n = res["n_nodes"]
    same = np.array_equal(res["vo_poses"], first["vo_poses"])
    log(f"# per-frame path, every row Paeth: odometry poses "
        f"{'identical to' if same else 'differ from'} the first run's")
    log(f"# per-frame path, every row Paeth: PNG decode per image "
        f"(median of {len(paths)}; host CPU): native "
        f"{dec['native']:.3f} ms (the path's reader), Python "
        f"{dec['python']:.3f} ms; {res['fps']:.3f} fps (the "
        f"written mix: "
        f"{first['fps']:.3f}); ATE={res['ate_m']:.4f} m (the written mix: "
        f"{first['ate_m']:.4f} m); span totals " + ", ".join(
            f"{k} {spans.get(k, 0.0):.1f} ms ({spans.get(k, 0.0) / n:.2f} "
            f"ms per frame)" for k in PF_SPANS))
    if n != first["n_nodes"] or not res["ate_m"] <= PF_ATE_BOUND_M:
        raise AssertionError(f"per-frame path, every row Paeth: nodes {n}, "
                             f"ATE {res['ate_m']} m")


def pf_spread_phase(seq, workdir, n):
    """The per-frame path with RANSAC seed sets 1..n (quality only)."""
    import os
    from tpuslam_torch.cli import slam_batch
    ates = []
    for k in range(1, n + 1):
        res = slam_batch.run(seq, pf_config(), quiet=True,
                             out_dir=os.path.join(workdir, f"spread{k}"),
                             draws_fn=pf_draws(k))
        ates.append(res["ate_m"])
        log(f"# per-frame spread seed set {k}: {res['fps']:.3f} fps; "
            f"ATE={res['ate_m']:.4f} m, {res['n_loop_closures']} loop "
            f"closures")
    log(f"# per-frame spread over {n} seed sets: ATE {min(ates):.4f}-"
        f"{max(ates):.4f} m")


def spread_phase(camera, cfg, staged, items, gt, n, what=""):
    """The main path in `cfg` with RANSAC seeds 1..n (quality only)."""
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
        log(f"# {what}spread seed {seed}: {N_FRAMES / dt:.3f} fps; "
            f"{fmt(q)}")
    log(f"# {what}spread over {n} seeds: ATE {min(ates):.4f}-"
        f"{max(ates):.4f} m")


def launched_kernels(fn):
    """CUDA kernels that fn() launches, by torch.profiler's count (None
    where the profiler records no kernel)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def peak_mib(fn):
    """fn()'s result and the card memory it allocated at its peak, MiB
    above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def depth_engines_phase(lefts, rights, camera):
    """The depth engines outside the kernels, plain PyTorch on the card,
    at full width on frame 0 of the bench: SGBM at SGBMConfig() with and
    without speckle equal to the CPU bit for bit, then timed on one frame
    and on a 30-frame chunk (its groups); LK over CAPACITY points (frame
    0's keypoints, 6 levels) against the CPU; the integer rectification
    warp at the reference calibration's 640x480 equal to the CPU.
    Returns the numbers PERF.md records."""
    from tpuslam_torch.config import SGBMConfig, SlamConfig
    from tpuslam_torch.io.synthetic import make_sequence
    from tpuslam_torch.kernels import sgbm as S
    from tpuslam_torch.kernels.lk_stereo import lk_stereo
    from tpuslam_torch.kernels.rectify import StereoRectifier
    from tpuslam_torch.runtime.pipeline import extract_features
    from tpuslam_torch.tools.timing import call_ms, time_ms, times_ms
    from tpuslam_torch.vo.frame import CAPACITY as PF_CAPACITY
    out = {}
    cfg = SGBMConfig()
    l, r = lefts[:1].contiguous(), rights[:1].contiguous()
    raw, out["sgbm_peak_mib"] = peak_mib(
        lambda: S.sgbm(l, r, cfg, with_speckle=False, device="cuda"))
    speckled = S.sgbm(l, r, cfg, with_speckle=True, device="cuda")
    t0 = time.perf_counter()
    raw_cpu = S.sgbm(l.cpu(), r.cpu(), cfg, with_speckle=False,
                     device="cpu")
    cpu_s = time.perf_counter() - t0
    speckled_cpu = S.speckle_sgbm(raw_cpu, cfg)
    if not (torch.equal(raw.cpu(), raw_cpu) and
            torch.equal(speckled.cpu(), speckled_cpu)):
        raise AssertionError("SGBM: the card differs from the CPU")
    invalid = (cfg.min_disparity - 1) * 16
    valid = float((raw != invalid).float().mean())
    fn = lambda: S.sgbm(l, r, cfg, with_speckle=False, device="cuda")
    out.update(sgbm_ms=time_ms(fn, runs=3), sgbm_call_ms=call_ms(fn, runs=3),
               sgbm_launches=launched_kernels(fn))
    log(f"# SGBM {WIDTH}x{HEIGHT} at SGBMConfig(): card == CPU bit for bit "
        f"with and without speckle ({valid:.3f} of the pixels valid, "
        f"{int((speckled != raw).sum())} filtered); one frame "
        f"{out['sgbm_ms']:.3f} ms (CUDA events behind the spin), "
        f"{out['sgbm_call_ms']:.3f} ms unspun, {out['sgbm_launches']} "
        f"kernel launches (torch.profiler), peak "
        f"{out['sgbm_peak_mib']:.1f} MiB; the CPU {cpu_s:.2f} s (host)")
    lc, rc = lefts[:CHUNK].contiguous(), rights[:CHUNK].contiguous()
    fn = lambda: S.sgbm(lc, rc, cfg, with_speckle=False, device="cuda")
    _, out["sgbm_chunk_peak_mib"] = peak_mib(fn)
    chunk_ms = sorted(times_ms(fn, runs=2, spin=False))[0]
    out["sgbm_chunk_ms_per_frame"] = chunk_ms / CHUNK
    group = S.group_size(HEIGHT, WIDTH, cfg)
    log(f"# SGBM {CHUNK}-frame chunk in groups of {group}: {chunk_ms:.1f} "
        f"ms unspun = {out['sgbm_chunk_ms_per_frame']:.3f} ms per frame; "
        f"peak {out['sgbm_chunk_peak_mib']:.1f} MiB")

    lk_cfg = SlamConfig().lk
    frame = extract_features(l[0].cpu().numpy(), r[0].cpu().numpy(), camera,
                             SlamConfig())
    n = len(frame.kpts)
    pts = np.zeros((PF_CAPACITY, 2), np.float32)
    pts[:n] = frame.kpts[:, :2]
    val = np.arange(PF_CAPACITY) < n
    kw = dict(win=(lk_cfg.win_w, lk_cfg.win_h), max_level=lk_cfg.max_level,
              max_iters=lk_cfg.iterations, eps=lk_cfg.epsilon,
              min_eig_threshold=lk_cfg.min_eig_threshold)
    cn, cs, _ = (t.cpu().numpy() for t in lk_stereo(l[0], r[0], pts, val,
                                                    device="cuda", **kw))
    t0 = time.perf_counter()
    pn, ps, _ = (t.numpy() for t in lk_stereo(l[0].cpu(), r[0].cpu(), pts,
                                              val, device="cpu", **kw))
    cpu_s = time.perf_counter() - t0
    same = float((cs == ps).mean())
    both = cs & ps
    x_err = float(np.abs(cn[both, 0] - pn[both, 0]).max())
    if not (same >= LK_STATUS_MIN and x_err <= LK_X_TOL and both.sum()):
        raise AssertionError(f"LK: card against CPU: status equal on "
                             f"{same}, x differs by {x_err} px")
    fn = lambda: lk_stereo(l[0], r[0], pts, val, device="cuda", **kw)
    out.update(lk_ms=time_ms(fn, runs=3), lk_call_ms=call_ms(fn, runs=3),
               lk_launches=launched_kernels(fn))
    log(f"# LK {PF_CAPACITY} points ({n} keypoints of frame 0), "
        f"{lk_cfg.max_level + 1} levels, {lk_cfg.iterations} iterations: "
        f"status equal to the CPU on {same:.4f} of the points ({int(cs.sum())}"
        f" tracked), x within {x_err:.3g} px (tolerances {LK_STATUS_MIN}, "
        f"{LK_X_TOL}); {out['lk_ms']:.3f} ms (events behind the spin), "
        f"{out['lk_call_ms']:.3f} ms unspun, {out['lk_launches']} kernel "
        f"launches; the CPU {cpu_s:.2f} s (host)")

    img = make_sequence(2, 640, 480, 500.0, 0.12, 0.3, 0.0, 5)[0]
    rect = StereoRectifier.from_reference_calib(device="cuda")
    rect_cpu = StereoRectifier.from_reference_calib(device="cpu")
    got = rect(img[0], img[1])
    want = rect_cpu(img[0].cpu(), img[1].cpu())
    if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
        raise AssertionError("rectify: the hw warp on the card differs from "
                             "the CPU")
    out["rectify_ms"] = time_ms(lambda: rect(img[0], img[1]))
    log(f"# rectify 640x480 (reference calibration, integer warp): card == "
        f"CPU bit for bit; both images {out['rectify_ms']:.4f} ms")
    return out


def sgbm_main_path_phase(camera, staged, items, gt):
    """bench.py's run with SGBM: run_staged over the 120 frames in
    SlamConfig(depth_method="sgbm") with a Mapper (async loop closure,
    device dictionary), every counter reset just before; K2, K3, K4 and K6
    launched, K1 and K5 not, no plain version; bench.py:240's gates (which
    tpuslam's own run passes) and ATE within SGBM_ATE_BOUND_M.  Returns
    fps."""
    from tpuslam_torch.config import DepthMethod, SlamConfig
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.mapping.mapper import Mapper
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    cfg = SlamConfig(depth_method=DepthMethod.SGBM)
    pipe = FastSlamPipeline(camera, cfg, chunk=CHUNK, capacity=CAPACITY,
                            seed=SEED)
    mp = Mapper(camera, cfg.mapper, cfg.matching, cfg.pnp)
    mp.async_lc = True
    _cuda.reset_counters()

    def run():
        t0 = time.perf_counter()
        infos = pipe.run_staged(staged, items, mapper=mp, mapper_async=True)
        torch.cuda.synchronize()
        return infos, time.perf_counter() - t0
    (infos, dt), peak = peak_mib(run)
    launches, plain = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
    q = quality(infos, gt)
    fps = N_FRAMES / dt
    log(f"# SGBM main path: {N_FRAMES} frames {WIDTH}x{HEIGHT} in {dt:.3f} s"
        f" = {fps:.3f} fps; {fmt(q)}; peak {peak:.1f} MiB above the staged "
        f"frames; mapper {len(mp.nodes)} nodes, "
        f"{len(mp.loop_closures)} loop closures")
    log(f"# SGBM main path: launches {launches}, plain calls {plain}")
    need = ("gftt", "orb", "median", "lm_refine")
    if any(launches[k] == 0 for k in need) or launches["stereo_bm"] or \
            launches["lr_check"] or any(launches[k] for k in _cuda.TOOLS) \
            or any(plain.values()):
        raise AssertionError(f"SGBM main path: launches {launches}, plain "
                             f"{plain}")
    if len(mp.nodes) != N_FRAMES:
        raise AssertionError("SGBM main path: the Mapper lacks a node per "
                             "frame")
    if q["lost"] > MAX_LOST or q["median_inliers"] < MIN_MEDIAN_INLIERS \
            or not q["t_err"] <= MAX_T_ERR_PCT:
        raise AssertionError(f"SGBM main path: bench gates failed: {fmt(q)}")
    if not q["ate"] <= SGBM_ATE_BOUND_M:
        raise AssertionError(f"SGBM main path: ATE {q['ate']} m above the "
                             f"bound {SGBM_ATE_BOUND_M} m")
    return fps, peak


def _realtime_run(seq, cfg, out, **kw):
    """slam_realtime.run on the card, every counter reset just before;
    returns (result, lost frames, launches, plain calls)."""
    from tpuslam_torch.cli import slam_realtime
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.vo import odometry as O
    process, lost = O.Odometry.process, []

    def recorded(self, frame):
        info = process(self, frame)
        lost.append(info.lost)
        return info
    O.Odometry.process = recorded
    try:
        _cuda.reset_counters()
        torch.cuda.synchronize()
        res = slam_realtime.run(seq, cfg, quiet=True, out_dir=out, **kw)
        torch.cuda.synchronize()
    finally:
        O.Odometry.process = process
    return res, sum(lost[1:]), dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)


def realtime_phase(seq, workdir):
    """The realtime app (cli/slam_realtime.py) over the per-frame phase's
    sequence in pf_config(): with "bm", pipelined, with asynchronous and
    with synchronous loop closure, its VO poses equal slam_batch.run's on
    the same RANSAC draws; then "sgbm" and "lk"
    (the lk run with telemetry): 0 lost, a loop closure, ATE within
    RT_ATE_BOUND_M, K2 and K3 once per frame, K1 and K5 never, no plain
    version.  Returns {method: (fps, p50 ms, p95 ms)}."""
    import os
    from tpuslam_torch.cli import slam_batch
    from tpuslam_torch.config import DepthMethod
    cfg = pf_config()
    draws = pf_draws(1)
    batch = slam_batch.run(seq, cfg, quiet=True, draws_fn=draws,
                           out_dir=os.path.join(workdir, "rt_batch"))
    res, lost, launches, plain = _realtime_run(
        seq, cfg, os.path.join(workdir, "rt_bm"), draws_fn=draws,
        pipelined=True, async_lc=True)
    n = res["n_frames"]
    if not np.array_equal(res["vo_poses"], batch["vo_poses"]):
        raise AssertionError("realtime bm: the VO poses differ from the "
                             "batch app's on the same draws")
    out = {"bm": (res["fps"], res["latency_ms_p50"], res["latency_ms_p95"])}
    log(f"# realtime bm (pipelined, async LC): {n} frames at "
        f"{res['fps']:.3f} fps, latency p50 {res['latency_ms_p50']:.2f} ms,"
        f" p95 {res['latency_ms_p95']:.2f} ms; VO poses identical to the "
        f"batch app's ({batch['fps']:.3f} fps) on the same draws; lost "
        f"{lost}, {res['n_loop_closures']} loop closures, "
        f"ATE={res['ate_m']:.4f} m")
    sync, _, _, _ = _realtime_run(
        seq, cfg, os.path.join(workdir, "rt_bm_sync"), draws_fn=draws,
        pipelined=True, async_lc=False)
    if not np.array_equal(sync["vo_poses"], batch["vo_poses"]):
        raise AssertionError("realtime bm, synchronous LC: the VO poses "
                             "differ from the batch app's")
    out["bm_sync_lc"] = (sync["fps"], sync["latency_ms_p50"],
                         sync["latency_ms_p95"])
    log(f"# realtime bm (pipelined, synchronous LC): {sync['fps']:.3f} fps, "
        f"latency p50 {sync['latency_ms_p50']:.2f} ms, p95 "
        f"{sync['latency_ms_p95']:.2f} ms; VO poses identical")
    for method in ("sgbm", "lk"):
        tel = os.path.join(workdir, "telemetry") if method == "lk" else None
        res, lost, launches, plain = _realtime_run(
            seq, cfg.replace(depth_method=DepthMethod(method)),
            os.path.join(workdir, f"rt_{method}"), telemetry_dir=tel)
        out[method] = (res["fps"], res["latency_ms_p50"],
                       res["latency_ms_p95"])
        log(f"# realtime {method}: {n} frames at {res['fps']:.3f} fps, "
            f"latency p50 {res['latency_ms_p50']:.2f} ms, p95 "
            f"{res['latency_ms_p95']:.2f} ms; lost {lost}, "
            f"{res['n_loop_closures']} loop closures, "
            f"ATE={res['ate_m']:.4f} m (bound {RT_ATE_BOUND_M[method]} m); "
            f"launches {launches}, plain calls {plain}")
        if lost or res["n_loop_closures"] < 1 or \
                not res["ate_m"] <= RT_ATE_BOUND_M[method]:
            raise AssertionError(f"realtime {method}: lost {lost}, loop "
                                 f"closures {res['n_loop_closures']}, ATE "
                                 f"{res['ate_m']} m")
        if launches["stereo_bm"] or launches["lr_check"] or \
                launches["gftt"] != n or launches["orb"] != n or \
                any(plain.values()):
            raise AssertionError(f"realtime {method}: launches {launches}, "
                                 f"plain {plain}")
        if tel is not None:
            st = res["telemetry"]
            if not os.path.exists(os.path.join(tel, "latest.json")) or \
                    not st["published"] >= 1:
                raise AssertionError(f"telemetry: {st}, latest.json "
                                     f"missing")
            log(f"# telemetry (realtime {method}): {st['published']} "
                f"frames published, {st['dropped']} dropped; latest.json "
                f"present")
    return out


def realtime_spread_phase(seq, workdir, n):
    """The realtime app's sgbm and lk runs with RANSAC seed sets 1..n
    (quality only)."""
    import os
    from tpuslam_torch.cli import slam_realtime
    from tpuslam_torch.config import DepthMethod
    for method in ("sgbm", "lk"):
        ates = []
        for k in range(1, n + 1):
            res = slam_realtime.run(
                seq, pf_config().replace(depth_method=DepthMethod(method)),
                quiet=True, out_dir=os.path.join(workdir, f"rts{k}"),
                draws_fn=pf_draws(k))
            ates.append(res["ate_m"])
            log(f"# realtime {method} spread seed set {k}: ATE="
                f"{res['ate_m']:.4f} m, {res['n_loop_closures']} loop "
                f"closures")
        log(f"# realtime {method} spread over {n} seed sets: ATE "
            f"{min(ates):.4f}-{max(ates):.4f} m")


def graph_ate(optimized, mapper):
    """ATE of optimized poses against the ground truth of the Mapper's
    nodes, as cli/slam_batch.py scores it."""
    from tpuslam_torch.geometry.kitti_metric import ate_rmse
    ids = [i for i in sorted(optimized)
           if mapper.nodes.get(i) is not None and
           mapper.nodes[i].frame.gt_pose is not None]
    return ate_rmse(np.stack([mapper.nodes[i].frame.gt_pose for i in ids]),
                    np.stack([optimized[i] for i in ids]))


def pose_diff(a, b):
    """The largest translation difference of two pose dicts (same ids)."""
    if sorted(a) != sorted(b):
        raise AssertionError("the two pose graphs hold other vertices")
    return max(float(np.abs(np.asarray(a[k])[:3, 3] -
                            np.asarray(b[k])[:3, 3]).max()) for k in a)


def hold_backends(what, got, ref, tol):
    """Hold a (poses, chi2) result to a reference one within `tol`."""
    diff = pose_diff(got[0], ref[0])
    rel = abs(got[1] - ref[1]) / (ref[1] + 1e-9)
    if not (diff <= tol["t"] and rel <= tol["chi2"]):
        raise AssertionError(f"{what}: translations differ by {diff} m "
                             f"(tolerance {tol['t']}), chi2 {got[1]} vs "
                             f"{ref[1]} (rel {rel}, tolerance {tol['chi2']})")
    return diff, rel


def counting_iterations():
    """Count the LM iterations of the sparse and dense device solvers, and
    keep K7's first input (a copy) and the (n, m) of each of its calls.
    Returns (the counts, K7's inputs, restore)."""
    from tpuslam_torch.optim import device as DEV
    counts = {"lm_solve_sparse": 0, "lm_solve": 0}
    k7 = {"first": None, "shapes": []}
    origs = {k: getattr(DEV, k) for k in (*counts, "thomas_solve_cuda")}

    def counted(name):
        def call(*args, iterations=10, **kw):
            counts[name] += iterations
            return origs[name](*args, iterations=iterations, **kw)
        return call

    def kept(D, S, B, lam):
        if k7["first"] is None:
            k7["first"] = tuple(a.clone() for a in (D, S, B, lam))
        k7["shapes"].append((B.shape[0], B.shape[2]))
        return origs["thomas_solve_cuda"](D, S, B, lam)
    for k in counts:
        setattr(DEV, k, counted(k))
    DEV.thomas_solve_cuda = kept
    return counts, k7, lambda: [setattr(DEV, k, v) for k, v in origs.items()]


def timed_robust(poses, links, cfg, backend):
    """run_optimize_robust on the card's host wall; returns ((poses,
    chi2), seconds, K7 launches, plain solves, the link set of each
    round)."""
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.optim import pose_graph as PG
    rounds, orig = [], PG.get_connected_graph

    def rec(root, p, lk):
        rounds.append({(x.from_id, x.to_id) for x in lk.values()})
        return orig(root, p, lk)
    PG.get_connected_graph = rec
    try:
        _cuda.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = PG.run_optimize_robust(poses, links, cfg.final_iterations,
                                     cfg, backend=backend)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        PG.get_connected_graph = orig
    return (out, dt, _cuda.LAUNCHES["thomas"], _cuda.PLAIN_CALLS["thomas"],
            rounds)


def backend_phase(seq, workdir, straight, rows):
    """Phase 14 (a) and (b): the batch app with -device-opt over the
    per-frame sequence, cut after frame 29 with a checkpoint and resumed
    to the end; the resumed run is (a)'s run, every counter reset just
    before it.  Then the replay of its map CSVs."""
    import os
    from tpuslam_torch.cli import optimize_replay, slam_batch
    from tpuslam_torch.io.dataset import load_poses
    from tpuslam_torch.kernels import _cuda
    cfg = pf_config()

    cp = os.path.join(workdir, "be_checkpoint.npz")
    t0 = time.perf_counter()
    slam_batch.run(seq, cfg, num_images=BE_CHECKPOINT - 1, quiet=True,
                   opt_backend="device", checkpoint_every=BE_CHECKPOINT,
                   checkpoint_path=cp,
                   out_dir=os.path.join(workdir, "be_part1"))
    t1 = time.perf_counter()
    part2 = os.path.join(workdir, "be_part2")
    counts, k7_in, restore = counting_iterations()
    try:
        _cuda.reset_counters()
        torch.cuda.synchronize()
        res = slam_batch.run(seq, cfg, quiet=True, opt_backend="device",
                             resume_from=cp, out_dir=part2)
        torch.cuda.synchronize()
    finally:
        restore()
    t2 = time.perf_counter()
    launches, plain = _cuda.LAUNCHES["thomas"], _cuda.PLAIN_CALLS["thomas"]
    iters = counts["lm_solve_sparse"]

    # (b) the resumed run against phase 10's straight run, bit for bit
    a, b = straight["mapper"], res["mapper"]
    pa, la = a.get_graph()
    pb, lb = b.get_graph()
    same = (sorted(pa) == sorted(pb) and
            all(np.array_equal(pa[i], pb[i]) for i in pa) and
            sorted((x.from_id, x.to_id, x.type) for x in la.values()) ==
            sorted((x.from_id, x.to_id, x.type) for x in lb.values()) and
            len(a.vwd) == len(b.vwd) and
            all(a.nodes[i].words == b.nodes[i].words for i in a.nodes) and
            np.array_equal(straight["vo_poses"], res["vo_poses"]))
    if not same:
        raise AssertionError("back end (b): the resumed run differs from "
                             "the straight run")
    replay = optimize_replay.run(
        os.path.join(part2, "map_poses.csv"),
        os.path.join(part2, "map_links.csv"),
        out_path=os.path.join(workdir, "be_replay.csv"), quiet=True)
    d_replay = pose_diff(replay["optimized"], load_poses(
        os.path.join(part2, "optimized_poses.csv")))
    if not d_replay <= 1e-3:
        raise AssertionError(f"back end (b): the replay differs from the "
                             f"batch app's optimized poses by {d_replay}")
    log(f"# back end (b): slam_batch -device-opt over frames 0-"
        f"{BE_CHECKPOINT - 1} with a checkpoint ({os.path.getsize(cp)} "
        f"bytes) {t1 - t0:.2f} s, resumed to frame {res['n_frames'] - 1} "
        f"{t2 - t1:.2f} s: Mapper ids, poses, links, words and VO poses "
        f"equal phase 10's straight run bit for bit; the replay (host back "
        f"end) of its map CSVs within {d_replay:.2e} m of its "
        f"optimized_poses.csv (CSV round trip, tolerance 1e-3)")

    # (a) the resumed run's device back end
    log(f"# back end (a): the resumed run's pose graph: {res['n_nodes']} "
        f"nodes, {res['n_links']} links, {res['n_loop_closures']} loop "
        f"closures; {iters} sparse LM iterations ({counts['lm_solve']} "
        f"dense), K7 launched {launches} times, plain solves {plain}; "
        f"ATE={res['ate_m']:.4f} m")
    if not (iters > 0 and launches >= iters and plain == 0):
        raise AssertionError(f"back end (a): K7 launches {launches} for "
                             f"{iters} LM iterations, plain {plain}")
    if not res["ate_m"] <= PF_ATE_BOUND_M:
        raise AssertionError(f"back end (a): ATE {res['ate_m']} m above "
                             f"{PF_ATE_BOUND_M} m")
    walls, out = {}, {}
    for backend in ("host", "device", "device-dense"):
        out[backend], walls[backend], _, _, rounds = timed_robust(
            pb, lb, cfg.optimizer, backend)
    app = (res["optimized"], res["chi2"])
    d_host, r_host = hold_backends("back end (a), device vs host", app,
                                   out["host"], BE_HOST_TOL)
    d_dense, r_dense = hold_backends("back end (a), dense vs device",
                                     out["device-dense"], out["device"],
                                     BE_DENSE_TOL)
    ate = {k: graph_ate(v[0], b) for k, v in out.items()}
    # the device back end twice on one graph: its scatter-adds are atomics
    rerun = pose_diff(app[0], out["device"][0])
    log(f"# back end (a): the device back end run twice on the same graph "
        f"(the app's, then alone): bit for bit "
        f"{rerun == 0.0 and app[1] == out['device'][1]}, translations "
        f"within {rerun:.3e} m, chi2 {app[1]!r} vs {out['device'][1]!r}")
    log(f"# back end (a): robust pose graph ({len(rounds)} rounds) host wall"
        f" host {walls['host']:.3f} s, device {walls['device']:.3f} s, "
        f"device-dense {walls['device-dense']:.3f} s; chi2 host "
        f"{out['host'][1]:.6g}, the app's device {app[1]:.6g} (rel "
        f"{r_host:.2e}), device-dense {out['device-dense'][1]:.6g} (rel to "
        f"device {r_dense:.2e}); translations: device vs host {d_host:.3e} "
        f"m, dense vs device {d_dense:.3e} m; ATE host {ate['host']:.5f}, "
        f"device {ate['device']:.5f} ({ate['device'] - ate['host']:+.2e}),"
        f" device-dense {ate['device-dense']:.5f} "
        f"({ate['device-dense'] - ate['host']:+.2e}) m")
    # K7 on the main path's own input: the first system the resumed run
    # gave it (the Woodbury extras' P columns included)
    shapes = sorted(set(k7_in["shapes"]))
    log(f"# back end (a): K7's (n, m) in the resumed run: {shapes}")
    main = hold_k7("the first system the resumed run's pose graph gave it",
                   *k7_in["first"], plain_runs=3)
    rows["thomas"] = dict(name="thomas", route="cuda",
                          source="tpuslam_torch/csrc/thomas.cu",
                          replaces="tpuslam/optim/device.py:546",
                          launches=launches, **main)


def k7_cut_ms(D, S, B, lam):
    """K7's whole solve and its forward pass alone (`tpuslam_thomas_stage`
    cut after it), spun ms: (whole, forward, backward)."""
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.tools.thomas_probe import solver
    from tpuslam_torch.tools.timing import time_ms
    whole, _ = solver(_cuda.library("thomas"), D, S, B, lam)
    fwd, _ = solver(_cuda.library("thomas"), D, S, B, lam, stop=1)
    t, f = time_ms(whole), time_ms(fwd)
    return t, f, t - f


@functools.lru_cache(maxsize=None)
def k7_chain_cycles():
    """(the card's largest SM clock in MHz, cycles of one forward step of
    K7's factor chain, of one backward step of a column) from the built
    library's SASS (tools/sass_chain.py)."""
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.tools import sass_chain
    from tpuslam_torch.tools.thomas_probe import sass
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True, check=True, timeout=60).stdout.split()[0])
    with tempfile.TemporaryDirectory() as d:
        text = sass(_cuda._lib_path("thomas"), f"{d}/k7.sass")
    insns = next(v for k, v in sass_chain.functions(text).items()
                 if "ILi0E" in k)
    # the factor chain's loop holds the square roots; the columns' loops
    # store G and X and copy nothing, the backward one last; the rare
    # path (div_small) is the one that scales by 2^100
    steps = []
    for marker, index, exclude in (("MUFU.RSQ", 0, None),
                                   ("STG", -1, "LDGSTS")):
        lo, hi = sass_chain.outermost(insns, marker, index, exclude)
        steps.append(sass_chain.chain(sass_chain.walk(
            insns, lo, hi, rare=K7_RARE))[0])
    log(f"# K7's chain from its SASS (tools/sass_chain.py): forward step "
        f"{steps[0]} cycles, backward step {steps[1]} cycles, at {mhz:g} "
        f"MHz")
    return mhz, steps[0], steps[1]


def k7_chain_ms(n):
    """The chain bound of an n-vertex solve: n - 1 forward steps of the
    factor chain and n backward steps of a column, at the card's largest
    SM clock."""
    mhz, forward, backward = k7_chain_cycles()
    return ((n - 1) * forward + n * backward) / (mhz * 1e3)


def hold_k7(what, D, S, B, lam, plain_runs=1, plain=True):
    """K7 against its plain version on one system, bit for bit, both
    timed: K7 spun and unspun, its forward and backward passes apart, the
    plain version unspun; the dense torch.linalg.solve of the same system
    beside it.  Where `plain` is False (a graph at KITTI 00's size, where
    the plain version takes minutes) it is not run.  Returns the numbers
    of K7's row for this shape."""
    from tpuslam_torch.optim import device as DEV
    from tpuslam_torch.tools.thomas_probe import BE_CUT
    from tpuslam_torch.tools.timing import bound, call_ms, time_ms
    kx = DEV.thomas_solve_cuda(D, S, B, lam)
    px = DEV._thomas_solve(D, S, B, lam) if plain else None
    torch.cuda.synchronize()
    err = max_abs_err(kx, px) if plain else None
    if plain and not torch.equal(kx, px):
        raise AssertionError(f"K7, {what}: differs from its plain version "
                             f"by {err} (tolerance 0: bit for bit)")
    n, m = B.shape[0], B.shape[2]
    b_ms, b_by = bound(*k7_bound(n, m))
    k_ms, f_ms, bw_ms = k7_cut_ms(D, S, B, lam)
    k_call = call_ms(lambda: DEV.thomas_solve_cuda(D, S, B, lam))
    p_ms = call_ms(lambda: DEV._thomas_solve(D, S, B, lam),
                   runs=plain_runs) if plain else None
    # the library yardstick: one dense solve of the same (6n)^2 system
    A = torch.zeros((n, 6, n, 6), device="cuda")
    k_ = torch.arange(n, device="cuda")
    A[k_, :, k_, :] = D + lam * torch.eye(6, device="cuda")
    A[k_[1:], :, k_[:-1], :] = S
    A[k_[:-1], :, k_[1:], :] = S.transpose(1, 2)
    A = A.reshape(6 * n, 6 * n)
    rhs = B.reshape(6 * n, m)
    lib_x = torch.linalg.solve(A, rhs).reshape(n, 6, m)
    lib_ms = time_ms(lambda: torch.linalg.solve(A, rhs),
                     runs=3 if n > BE_CUT else 20)
    ref = px if plain else kx
    lib_err = max_abs_err(lib_x, ref) / float(ref.abs().max())
    del A, lib_x
    torch.cuda.empty_cache()
    chain = k7_chain_ms(n)
    log(f"# K7 at {n} vertices x {m} columns ({what}): " +
        (f"bit for bit its plain version; " if plain else
         "(the plain version not run); ") +
        f"K7 {k_ms:.4f} ms spun (forward pass {f_ms:.4f}, backward "
        f"{bw_ms:.4f}; {k_call:.4f} unspun, {k_ms * 1e3 / (2 * n):.3f} us "
        f"per step, {-(-m // DEV.K7_MAX_COLS)} thread blocks)" +
        (f", plain {p_ms:.1f} ms (unspun, {plain_runs} runs)" if plain
         else "") +
        f", torch.linalg.solve dense {lib_ms:.4f} ms (differs by "
        f"{lib_err:.3e} of max|X|), bound {b_ms:.5f} ms ({b_by}), chain "
        f"bound {chain:.4f} ms")
    return dict(n=n, m=m, max_abs_err=err, ms=k_ms, forward_ms=f_ms,
                backward_ms=bw_ms, call_ms=k_call, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, chain_ms=chain,
                library_ms=lib_ms, step_us=k_ms * 1e3 / (2 * n),
                bit_equal=bool(torch.equal(kx, px)) if plain else None)


def k7_bound(n, m):
    """K7's bytes (D, S, B read; L, G, X written, f32) and operations for
    an (n, 6, m) solve: per forward step 6 + m column solves (72 each),
    36 + 6m entries of C_k and g_k (12 each) and a factorisation (~100);
    per backward step m columns of 72 + 72."""
    nbytes = 4 * (36 * n + 36 * (n - 1) + 6 * n * m + 36 * n +
                  2 * 6 * n * m)
    ops = n * ((6 + m) * 72 + (36 + 6 * m) * 12 + 100 + 144 * m)
    return nbytes, ops


def backend_scale_phase(rows, parent=None):
    """Phase 14 (c): the robust pose graph at KITTI 00's size on the host
    and twice with the device back end (bit for bit), then K7 against its
    plain version at a 1000-vertex cut and timed at the whole graph's
    size.  With `parent` (a parent tree, unpacked), K7 and the device back
    end in turns with the parent's."""
    from tpuslam_torch.config import OptimizerConfig
    from tpuslam_torch.mapping.graph import MultiMap
    from tpuslam_torch.tools.thomas_probe import (BE_CUT, first_system,
                                                  kitti_size_graph)
    cfg = OptimizerConfig()
    gt, poses, links, outlier = kitti_size_graph()
    n = len(poses)
    out, walls, k7, n_rounds = {}, {}, {}, {}
    for backend in ("host", "device", "device again"):
        out[backend], walls[backend], k7[backend], plain, rounds = \
            timed_robust(poses, links, cfg, backend.split()[0])
        n_rounds[backend] = len(rounds)
        if outlier not in rounds[0] or outlier in rounds[-1]:
            raise AssertionError(f"back end (c), {backend}: the outlier "
                                 f"{outlier} was not ejected")
    if not (k7["device"] >= 5 * (n_rounds["device"] - 1) + 20 and
            plain == 0 and k7["host"] == 0):
        raise AssertionError(f"back end (c): K7 launches {k7}, plain "
                             f"{plain}")
    # the device back end twice on one graph: its sums take one order (C7)
    a, b = out["device"], out["device again"]
    if sorted(a[0]) != sorted(b[0]) or a[1] != b[1] or not all(
            np.array_equal(a[0][k], b[0][k]) for k in a[0]):
        raise AssertionError(f"back end (c): two device runs differ by "
                             f"{pose_diff(a[0], b[0])} m, chi2 {a[1]!r} vs "
                             f"{b[1]!r}")
    diff, rel = hold_backends("back end (c), device vs host", out["device"],
                              out["host"], BE_HOST_TOL)
    ate = {k: float(np.sqrt(np.mean(np.sum(
        (np.stack([v[0][i + 1] for i in range(n)])[:, :3, 3] -
         gt[:, :3, 3]) ** 2, axis=1)))) for k, v in out.items()}
    log(f"# back end (c): {n} vertices, {len(links)} links; robust pose "
        f"graph host wall host {walls['host']:.3f} s ({n_rounds['host']} "
        f"rounds), device {walls['device']:.3f} s and again "
        f"{walls['device again']:.3f} s, bit for bit "
        f"({n_rounds['device']} rounds, K7 launched {k7['device']} times "
        f"each); chi2 host {out['host'][1]:.6g}, device "
        f"{out['device'][1]:.6g} (rel {rel:.2e}); largest translation "
        f"difference {diff:.3e} m (tolerance {BE_HOST_TOL['t']}); ATE "
        f"against the ground truth host {ate['host']:.4f} m, device "
        f"{ate['device']:.4f} m; the outlier {outlier} ejected by both")

    # K7 against its plain version on the first lambda's system of the
    # first BE_CUT vertices, and at the whole graph's size
    cut = {i: poses[i] for i in range(1, BE_CUT + 1)}
    D, S, B, lam = first_system(cut, MultiMap(
        (k, x) for k, x in links.items()
        if x.from_id <= BE_CUT and x.to_id <= BE_CUT), cfg.tau)
    cut = hold_k7(f"the first lambda's system of a {BE_CUT}-vertex cut",
                  D, S, B, lam)
    D, S, B, lam = first_system(poses, links, cfg.tau)
    whole = hold_k7("the whole graph's first system", D, S, B, lam,
                    plain=False)
    rows["thomas"].update(launches_scale=k7["device"], at_cut=cut,
                          at_4541=whole,
                          backend_s=[walls["device"], walls["device again"]])
    if parent:
        from tpuslam_torch.tools import backend_turns, thomas_probe
        import os
        turns = thomas_probe.run(source=os.path.join(
            parent, "tpuslam_torch", "csrc", "thomas.cu"))
        be = backend_turns.run(parent)
        rows["thomas"]["turns"] = dict(k7=turns, backend_s=be["median_s"])


# phase 15, the tool apps.  (d) stereo calibration: tests/test_calib.py's
# rig (K, D, R_LR, T_LR) and its 8 view draws (seed 1), rendered by the
# numpy renderer; the JAX suite's gates (tests/test_calib.py:71-86) and
# the card held to the CPU to tests/test_torch_calib.py's tolerances
CAL_K1 = np.array([[520.0, 0, 321.0], [0, 518.0, 242.0], [0, 0, 1]])
CAL_K2 = np.array([[515.0, 0, 318.0], [0, 516.0, 239.0], [0, 0, 1]])
CAL_RVEC_LR, CAL_T_LR = (0.004, -0.02, 0.006), (-0.061, 0.001, 0.002)
CAL_D1, CAL_D2 = [0.06, -0.04, 0, 0], [0.05, -0.03, 0, 0]
CAL_VIEWS, CAL_TOL = 8, dict(k_rel=1e-4, d=1e-4, t=1e-5)
# (c) the capture app over this many frames; (e) the main path on a world
# textured with the fixture's real frame: tests/test_real_texture.py:32-48
CAPTURE_FRAMES = 10
RT_FRAMES, RT_W, RT_H, RT_F, RT_CHUNK = 120, 640, 240, 350.0, 20
RT_SPEED, RT_YAW, RT_SEED = 1.4, 0.003, 11
RT_T_ERR_PCT, RT_ATE_M = 1.5, 1.5          # test_real_texture.py:79-84
# the port's own bound on the real-texture ATE: 1.33x the worst of four
# RANSAC seeds (0.7764 m, seed 0) in `chip_smoke.py --spread 3` on an
# NVIDIA H100 80GB HBM3, 700.00 W
RT_PHOTO_ATE_BOUND_M = 1.03


def counted(fn):
    """fn()'s result and the launches and plain calls it made, every
    counter reset just before it."""
    from tpuslam_torch.kernels import _cuda
    _cuda.reset_counters()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)


def expect_launches(what, launches, plain, want):
    """Exactly the launches `want` (kernel -> count, every other 0) and no
    plain version."""
    got = {k: v for k, v in launches.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    if any(plain.values()):
        raise AssertionError(f"{what}: a plain version ran: {plain}")


def kernel_test_phase(workdir):
    """(a) cli/kernel_test.py on the golden pair on the card and on the
    CPU: all_pass, 0 golden mismatches, K1, K5 and K2 once each, no plain
    version; the report equal to the CPU's (the float warp's numbers to
    1e-4) and the disparity bit for bit."""
    import os
    from tpuslam_torch.cli import kernel_test
    card, cpu = {}, {}
    t0 = time.perf_counter()
    rep, launches, plain = counted(lambda: kernel_test.run(
        out_dir=os.path.join(workdir, "kernel_test"), quiet=True,
        arrays=card))
    dt = time.perf_counter() - t0
    expect_launches("kernel_test", launches, plain,
                    dict(stereo_bm=1, lr_check=1, gftt=1))
    ref = kernel_test.run(out_dir=os.path.join(workdir, "kernel_test_cpu"),
                          quiet=True, device="cpu", arrays=cpu)
    if not rep["all_pass"] or rep["xsobel_vs_golden"]["mismatches"] != 0:
        raise AssertionError(f"kernel_test on the card: {rep}")
    for key in ref:
        if key == "rectify_hw_vs_float":
            ok = all(abs(rep[key][k] - ref[key][k]) <= 1e-4
                     for k in ("max_abs", "mean_abs"))
        else:
            ok = rep[key] == ref[key]
        if not ok:
            raise AssertionError(f"kernel_test {key}: card {rep[key]}, CPU "
                                 f"{ref[key]}")
    if not np.array_equal(card["disparity"], cpu["disparity"]):
        raise AssertionError("kernel_test: the card's disparity differs "
                             "from the CPU's")
    log(f"# tool apps (a) kernel_test on the golden pair: {dt:.3f} s on "
        f"the card; " + "; ".join(f"{k} {v}" for k, v in rep.items()))
    return launches


def hw_test_phase():
    """(b) cli/hw_test.py: 9dof, patterns and timing each exit 0; the
    patterns test launches K1, K5, K2 and K3's blur once per pattern and
    no plain version, and each pattern's outputs, from that same counted
    run, equal the CPU's bit for bit."""
    import contextlib
    import io
    from tpuslam_torch.cli import hw_test
    from tpuslam_torch.dist.mesh import frontend_one
    from tpuslam_torch.io.patterns import generate_pattern
    rcs, out, outputs = {}, {}, {}
    runs = {"9dof": lambda: hw_test.main(["9dof"]),
            "patterns": lambda: hw_test.test_patterns(outputs=outputs),
            "timing": lambda: hw_test.main(["timing"])}
    for test, run in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            rc, launches, plain = counted(run)
            dt = time.perf_counter() - t0
        rcs[test], out[test] = rc, buf.getvalue().splitlines()
        log(f"# tool apps (b) hw_test {test}: exit {rc}, {dt:.3f} s; " +
            " | ".join(out[test]))
        if test == "patterns":
            n = len(out[test])
            expect_launches("hw_test patterns", launches, plain,
                            dict(stereo_bm=n, lr_check=n, gftt=n,
                                 orb_blur=n))
            pattern_launches = launches
    if any(rcs.values()) or len(out["patterns"]) != 5 or len(outputs) != 5:
        raise AssertionError(f"hw_test: exit codes {rcs}")
    for pat, outs in outputs.items():
        img = generate_pattern(pat, *hw_test.PATTERN_SIZE)
        ref = [o.numpy() for o in frontend_one(img, img, device="cpu")]
        if not all(np.array_equal(a, b) for a, b in zip(outs, ref)):
            raise AssertionError(f"frontend_one on pattern {pat}: the card "
                                 f"differs from the CPU")
    rtt = float(out["timing"][0].split()[-2])
    return pattern_launches, rtt


def capture_phase(workdir):
    """(c) cli/stereo_capture.py -source synthetic -frontend over
    CAPTURE_FRAMES frames on the card: the KITTI layout, the seven dump
    hooks' files for every frame, keypoints in each; K1, K5 and K3 once
    per frame and K2 twice (the front end, and the response for the
    eigenvalue dump), no plain version."""
    import os
    from tpuslam_torch.cli import stereo_capture
    n = CAPTURE_FRAMES
    t0 = time.perf_counter()
    d, launches, plain = counted(lambda: stereo_capture.run(
        os.path.join(workdir, "capture"), n_frames=n, frontend=True,
        quiet=True))
    dt = time.perf_counter() - t0
    expect_launches("capture", launches, plain,
                    dict(stereo_bm=n, lr_check=n, orb=n, gftt=2 * n))
    names = [f"{i:06d}.png" for i in range(n)]
    for sub in ("image_0", "image_1"):
        if sorted(os.listdir(os.path.join(d, sub))) != names:
            raise AssertionError(f"capture: {sub} lacks frames")
    for f in ("calib.txt", "times.txt", "poses.txt"):
        if not os.path.exists(os.path.join(d, f)):
            raise AssertionError(f"capture: no {f}")
    dumps = set(os.listdir(os.path.join(d, "dumps")))
    kpts = []
    for i in range(n):
        want = {f"{k}_{i:06d}.png" for k in ("rect_l", "rect_r", "kpts",
                                             "depth", "eig")} | \
            {f"{k}_{i:06d}.csv" for k in ("kpts2d", "kpts3d", "desc")}
        if not want <= dumps:
            raise AssertionError(f"capture: frame {i} lacks "
                                 f"{sorted(want - dumps)}")
        with open(os.path.join(d, "dumps", f"kpts2d_{i:06d}.csv")) as f:
            kpts.append(sum(1 for _ in f))
    if min(kpts) == 0:
        raise AssertionError(f"capture: a frame without keypoints: {kpts}")
    log(f"# tool apps (c) capture: {n} frames 640x480 rendered, written, "
        f"front end and dumps on the card in {dt:.3f} s; keypoints per "
        f"frame {kpts}; {len(dumps)} dump files")
    return launches


def calib_phase(workdir):
    """(d) cli/stereo_calib.py over CAL_VIEWS rendered views of the rig
    written as PNGs, on the card and on the CPU: the JAX suite's gates
    and the card held to the CPU."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from tpuslam_torch.calib.calibrate import _rvec
    from tpuslam_torch.calib.chessboard import _rodrigues, render_chessboard
    from tpuslam_torch.cli import stereo_calib
    from tpuslam_torch.io.png import write_png
    rng = np.random.default_rng(1)
    r_lr, t_lr = _rodrigues(np.array(CAL_RVEC_LR)), np.array(CAL_T_LR)
    jobs = []
    for i in range(CAL_VIEWS):
        rvec = rng.uniform(-0.35, 0.35, 3)
        rvec[2] = rng.uniform(-0.25, 0.25)
        tvec = np.array([rng.uniform(-0.08, -0.02),
                         rng.uniform(-0.07, -0.02), rng.uniform(0.35, 0.6)])
        jobs.append(("image_0", i, CAL_K1, rvec, tvec, CAL_D1))
        jobs.append(("image_1", i, CAL_K2, _rvec(r_lr @ _rodrigues(rvec)),
                     r_lr @ tvec + t_lr, CAL_D2))
    views = os.path.join(workdir, "calib")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(views, sub))

    def render(job):
        sub, i, K, rvec, tvec, dist = job
        img, _ = render_chessboard(K, rvec, tvec, dist=dist)
        write_png(os.path.join(views, sub, f"{i:03d}.png"), img)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(render, jobs))
    log(f"# tool apps (d) calibration: rendered {2 * CAL_VIEWS} views on "
        f"the host in {time.perf_counter() - t0:.2f} s")
    res = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(workdir, f"calib_{dev}")
        os.makedirs(out)
        t0 = time.perf_counter()
        res[dev] = stereo_calib.run(views, out_dir=out, quiet=True,
                                    device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev]["wall_s"] = time.perf_counter() - t0
        files = sorted(os.listdir(out))
        if files != ["extrinsics.yml", "intrinsics.yml", "left_camera.yml",
                     "right_camera.yml"]:
            raise AssertionError(f"stereo_calib on {dev}: wrote {files}")
    c, p = res["cuda"], res["cpu"]
    b = float(np.linalg.norm(c["T"]))
    log(f"# tool apps (d) calibration, {c['n_views']} views: card "
        f"{c['wall_s']:.3f} s, CPU {p['wall_s']:.3f} s; rms {c['rms']:.6f} "
        f"px (CPU {p['rms']:.6f}); K1 {c['K1'].round(4).tolist()}; D1 "
        f"{c['D1'].round(6).tolist()}; T {c['T'].round(7).tolist()} m "
        f"(CPU {p['T'].round(7).tolist()}); |T| {b:.6f} m (true "
        f"{np.linalg.norm(t_lr):.6f})")
    if not (c["rms"] < 0.5 and abs(c["K1"][0, 0] - 520.0) / 520.0 < 0.02
            and abs(c["K2"][1, 1] - 516.0) / 516.0 < 0.02
            and abs(b - np.linalg.norm(t_lr)) < 0.001 and c["T"][0] < 0):
        raise AssertionError("calibration on the card misses the JAX "
                             "suite's gates")
    tol = CAL_TOL
    close = all(np.allclose(c[k], p[k], rtol=tol["k_rel"], atol=0)
                for k in ("K1", "K2")) and \
        all(np.allclose(c[k], p[k], rtol=0, atol=tol["d"])
            for k in ("D1", "D2")) and \
        np.allclose(c["T"], p["T"], rtol=0, atol=tol["t"])
    if not close or c["n_views"] != p["n_views"]:
        raise AssertionError(f"calibration: the card differs from the CPU "
                             f"beyond {tol}")
    return dict(card_s=c["wall_s"], cpu_s=p["wall_s"], rms=c["rms"],
                baseline_m=b)


def real_texture_run(seed=0):
    """tests/test_real_texture.py's sequence, textured with the fixture's
    real frame and rendered on the card, through run_staged with RANSAC
    seed `seed`, every counter reset just before the run.  Returns
    (quality, fps, launches, plain calls)."""
    import os
    from tpuslam_torch.config import SlamConfig
    from tpuslam_torch.io.synthetic import make_sequence, sequence_camera
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    photo = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "fixtures", "rect_left.npy"))
    t0 = time.perf_counter()
    lefts, rights, stamps, gt = make_sequence(
        RT_FRAMES, RT_W, RT_H, RT_F, BASELINE, RT_SPEED, RT_YAW, RT_SEED,
        texture_photo=photo)
    torch.cuda.synchronize()
    log(f"# real texture: rendered {RT_FRAMES} photo-textured stereo pairs "
        f"{RT_W}x{RT_H} on the card in {time.perf_counter() - t0:.2f} s")
    items = [dict(left=lefts[i], right=rights[i], stamp=stamps[i],
                  ground_truth=gt[i]) for i in range(RT_FRAMES)]
    pipe = FastSlamPipeline(sequence_camera(RT_W, RT_H, RT_F, BASELINE),
                            SlamConfig(), chunk=RT_CHUNK, capacity=CAPACITY,
                            seed=seed)
    staged = pipe.stage_chunks(items)
    t0 = time.perf_counter()
    infos, launches, plain = counted(lambda: pipe.run_staged(staged, items))
    dt = time.perf_counter() - t0
    q = quality(infos, gt)
    q["drift"] = drift_profile(infos, gt)
    return q, RT_FRAMES / dt, launches, plain


def _angle_deg(r):
    return math.degrees(math.acos(min(1.0, max(-1.0,
                                               (np.trace(r) - 1) / 2))))


def drift_profile(infos, gt, every=20, onset_m=0.1):
    """Where a run's error grows: the position error (m) and the heading
    error (deg) at every `every`-th frame and the last, the first frame
    whose position error passes `onset_m`, and the frame whose own step
    has the largest rotation error (deg)."""
    est = np.stack([i.pose for i in infos])
    pos = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    head = [_angle_deg(g[:3, :3].T @ e[:3, :3]) for g, e in zip(gt, est)]
    step = [_angle_deg((gt[i - 1, :3, :3].T @ gt[i, :3, :3]).T @
                       (est[i - 1, :3, :3].T @ est[i, :3, :3]))
            for i in range(1, len(est))]
    marks = list(range(every, len(est), every)) + [len(est) - 1]
    over = np.nonzero(pos > onset_m)[0]
    worst = int(np.argmax(step))
    return (f"position error m / heading error deg at frames " +
            ", ".join(f"{i}: {pos[i]:.4f} / {head[i]:.4f}" for i in marks) +
            f"; first frame past {onset_m} m: "
            f"{int(over[0]) if len(over) else None}; largest step rotation "
            f"error {step[worst]:.5f} deg at frame {worst + 1}")


def real_texture_spread(n):
    """The real-texture main path with RANSAC seeds 1..n (quality and
    where the error grows)."""
    ates = []
    for seed in range(1, n + 1):
        q, fps, _, _ = real_texture_run(seed)
        ates.append(q["ate"])
        log(f"# real texture spread seed {seed}: {fps:.3f} fps; {fmt(q)}")
        log(f"# real texture spread seed {seed} drift: {q['drift']}")
    log(f"# real texture spread over {n} seeds: ATE {min(ates):.4f}-"
        f"{max(ates):.4f} m")


def real_texture_phase():
    """(e) the main path on a world textured with the fixture's real
    frame (tests/test_real_texture.py's configuration), rendered on the
    card: run_staged, every counter reset just before it; 0 lost, finite
    t_err < 1.5 %, ATE < 1.5 m (the JAX suite's gates) and ATE within
    the port's own bound RT_PHOTO_ATE_BOUND_M, K1-K6 launched, no plain
    version."""
    from tpuslam_torch.kernels import _cuda
    q, fps, launches, plain = real_texture_run()
    log(f"# tool apps (e) real texture: {RT_FRAMES} frames at {fps:.3f} fps "
        f"(one run, counters reset before it); {fmt(q)} (bound "
        f"{RT_PHOTO_ATE_BOUND_M} m); launches {launches}")
    log(f"# tool apps (e) real texture drift: {q['drift']}")
    missing = [k for k in _cuda.KERNELS if launches[k] == 0]
    if missing or any(plain.values()):
        raise AssertionError(f"real texture: kernels not launched "
                             f"{missing} or plain calls {plain}")
    if q["lost"] != 0 or not math.isfinite(q["t_err"]) or \
            not q["t_err"] < RT_T_ERR_PCT or not q["ate"] < RT_ATE_M or \
            not q["ate"] <= RT_PHOTO_ATE_BOUND_M:
        raise AssertionError(f"real texture: gates failed: {fmt(q)} "
                             f"(bound {RT_PHOTO_ATE_BOUND_M} m)")
    return launches, fps, q


def tool_apps_phase(workdir, rows):
    """Phase 15, the tool apps on the card: (a)-(e).  Adds each kernel's
    launches in each of them to its row (`tool_apps`)."""
    t0 = time.perf_counter()
    counts = dict(kernel_test=kernel_test_phase(workdir))
    counts["hw_test_patterns"], rtt = hw_test_phase()
    counts["capture"] = capture_phase(workdir)
    cal = calib_phase(workdir)
    counts["real_texture"], rt_fps, rt_q = real_texture_phase()
    from tpuslam_torch.kernels import _cuda
    for k in _cuda.KERNELS + ("orb_blur",):
        rows[k]["tool_apps"] = {what: c[k] for what, c in counts.items()}
    log(f"# tool apps: phase 15 took {time.perf_counter() - t0:.2f} s")
    return dict(round_trip_ms=rtt, calib=cal, real_texture_fps=rt_fps,
                real_texture_ate_m=rt_q["ate"],
                real_texture_t_err_pct=rt_q["t_err"])


# phase 16, the multi-device layer (dist/): the sharded front end's mesh
# and frames (the bench's first DIST_FRAMES, its timing turns), the
# sharded pose graph's graph (tests/test_dist.py:141-200's noisy loop
# with a forward closure, at DIST_PG_VERTICES), the BA problem
# (tests/test_dist.py:195-225's), their tolerances (the JAX suite's:
# tests/test_dist.py:106-111 and 249-253), and the processes' time limit
DIST_SHARDS, DIST_FRAMES, DIST_TURNS = 4, 8, 3
DIST_PG_VERTICES, DIST_PG_ITERS, DIST_PG_SEED = 200, 5, 9
DIST_PG_TOL = dict(chi2=2e-3, t=2e-2)
DIST_BA = dict(W=8, L=256, O=2048, iterations=6, huber_delta=4.0, seed=0)
DIST_BA_TOL = dict(cost=5e-2, t=5e-3)
DIST_TIMEOUT_S = 300


def noisy_loop_arrays(n=None, seed=DIST_PG_SEED):
    """tests/test_optim.py's make_noisy_loop (a circle of n poses 1 m
    apart, odometry noise 0.05 m / 0.01 rad, Omega = 100 I, an exact
    closure last -> first) with a forward closure as
    tests/test_dist.py:150-153's (10 -> n - 30, a Woodbury extra), here
    exact: the suite's arbitrary one (0.5 m off, Omega = 2 I) makes the
    LM diverge at 200 vertices in tpuslam's lm_solve as in the port's
    (tests/test_torch_dist.py::test_suite_closure_diverges_in_both), as
    optim.device graph arrays (pose_arr, e_from, e_to, Z, Omega,
    free_idx)."""
    from tpuslam_torch.io.synthetic import exact_closure, noisy_circuit
    from tpuslam_torch.optim import device as dev
    n = n or DIST_PG_VERTICES
    gt, poses, links = noisy_circuit(n, n, np.random.default_rng(seed))
    exact_closure(links, gt, n - 1, 0)
    exact_closure(links, gt, 9, n - 31)
    return dev.graph_to_arrays(poses, links)[1:]


def ba_problem(W, L, O, seed):
    """tests/test_dist.py's _ba_problem: (intr, Tcw0, lms0, obs_cam,
    obs_lm, uv, obs_valid), numpy."""
    from tpuslam_torch.io.synthetic import se3_noise
    rng = np.random.default_rng(seed)
    intr = np.array([700.0, 700.0, 620.0, 188.0], np.float32)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    for i in range(W):
        Tcw[i] = np.linalg.inv(se3_noise(rng, 0.02, 0.005)) @ Tcw[i]
        Tcw[i, 2, 3] += -i * 0.5
    lms = np.stack([rng.uniform(-8, 8, L), rng.uniform(-3, 3, L),
                    rng.uniform(8, 30, L)], axis=1).astype(np.float32)
    obs_cam = rng.integers(0, W, O).astype(np.int32)
    obs_lm = rng.integers(0, L, O).astype(np.int32)
    uv = np.zeros((O, 2), np.float32)
    for k in range(O):
        T = Tcw[obs_cam[k]]
        p = T[:3, :3] @ lms[obs_lm[k]] + T[:3, 3]
        uv[k] = [intr[0] * p[0] / p[2] + intr[2],
                 intr[1] * p[1] / p[2] + intr[3]]
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    lms0 = lms + rng.normal(0, 0.05, lms.shape).astype(np.float32)
    Tcw0 = Tcw.copy()
    for i in range(1, W):
        Tcw0[i] = se3_noise(rng, 0.02, 0.004).astype(np.float32) @ Tcw0[i]
    return intr, Tcw0, lms0, obs_cam, obs_lm, uv, np.ones(O, bool)


def hold_pg(what, got, ref):
    """Sharded pose-graph results against a reference's: chi2 per
    iteration and translations within DIST_PG_TOL."""
    (gp, gc), (rp, rc) = [(np.asarray(p.cpu() if torch.is_tensor(p) else p),
                           np.asarray(c.cpu() if torch.is_tensor(c) else c))
                          for p, c in (got, ref)]
    dc = float(np.max(np.abs(gc - rc) / np.abs(rc)))
    dt = float(np.max(np.abs(gp[:, :3, 3] - rp[:, :3, 3])))
    if not (dc <= DIST_PG_TOL["chi2"] and dt <= DIST_PG_TOL["t"]):
        raise AssertionError(f"{what}: chi2 rel diff {dc}, translation "
                             f"diff {dt} m beyond {DIST_PG_TOL}")
    return dc, dt


def timed(fn, warm=False):
    """fn()'s result, its launches and plain calls (counters reset just
    before it) and its wall in seconds, synchronised; with `warm`, after
    one untimed call (the solvers' and the communicator's set-up)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, launches, plain = counted(fn)
    return out, launches, plain, time.perf_counter() - t0


def dist_frontend_part(lefts, rights):
    """(a) sharded_frontend_step on a mesh of DIST_SHARDS shards on the
    card over the bench's first DIST_FRAMES frames, speckle off and on:
    K1, K5, K2 and K3's blur launched once per shard and no plain
    version; every frame's outputs equal frontend_one's (with speckle;
    without it, StereoBM's unspeckled disparity) bit for bit; then a
    mesh of 1 and the mesh of DIST_SHARDS timed in turns on the same
    frames, and the sharding efficiency t(mesh 1) / t(mesh 4) (SCALING.md's,
    at fixed work on one card).  Returns (numbers, the speckle run's
    launches)."""
    from tpuslam_torch.config import StereoBMConfig
    from tpuslam_torch.dist.mesh import (frontend_one, make_mesh,
                                         sharded_frontend_step)
    from tpuslam_torch.kernels.stereo_bm import stereo_bm
    cfg = StereoBMConfig()
    L = lefts[:DIST_FRAMES].contiguous()
    R = rights[:DIST_FRAMES].contiguous()
    mesh = make_mesh(DIST_SHARDS)
    if mesh.devices != (torch.device("cuda", 0),) * DIST_SHARDS:
        raise AssertionError(f"make_mesh: {mesh}")
    n = DIST_SHARDS
    res, launches = {}, None
    for speckle in (False, True):
        step = sharded_frontend_step(mesh, cfg, with_speckle=speckle)
        got, la, pl, _ = timed(lambda: step(L, R))
        expect_launches(f"sharded front end, speckle {speckle}", la, pl,
                        dict(stereo_bm=n, lr_check=n, gftt=n, orb_blur=n))
        for i in range(DIST_FRAMES):
            d, e, b = frontend_one(L[i], R[i], cfg)
            if not speckle:
                d = stereo_bm(L[i:i + 1], R[i:i + 1], cfg,
                              with_speckle=False)[0]
            for a, w, what in zip(got, (d, e, b),
                                  ("disparity", "response", "blur")):
                if not torch.equal(a[i], w):
                    raise AssertionError(f"sharded front end, speckle "
                                         f"{speckle}: frame {i}'s {what} "
                                         f"differs from frontend_one's")
        one = sharded_frontend_step(make_mesh(1), cfg, with_speckle=speckle)
        walls = {1: [], n: []}
        for _ in range(DIST_TURNS):
            for k, fn in ((1, one), (n, step)):
                walls[k].append(timed(lambda: fn(L, R))[3] * 1e3)
        m1, mn = (float(np.median(walls[k])) for k in (1, n))
        res[f"speckle_{'on' if speckle else 'off'}"] = dict(
            mesh1_ms=m1, mesh4_ms=mn, efficiency=m1 / mn)
        launches = la
        log(f"# multi-device (a) sharded front end, speckle "
            f"{'on' if speckle else 'off'}: {DIST_FRAMES} frames "
            f"{WIDTH}x{HEIGHT} on {n} shards of one card, each frame bit "
            f"for bit frontend_one's; launches "
            f"{ {k: v for k, v in la.items() if v} }; mesh of 1 "
            f"{m1:.3f} ms, mesh of {n} "
            f"{mn:.3f} ms (medians of {DIST_TURNS} turns), sharding "
            f"efficiency {m1 / mn:.4f}")
    return res, launches


def dist_backend_runs(mesh, arrays):
    """The sharded dense and sparse pose-graph steps on `mesh` over the
    graph `arrays`: ((poses, chis) of each, launches and walls)."""
    from tpuslam_torch.dist.mesh import (pad_edges, sharded_pose_graph_step,
                                         sharded_pose_graph_step_sparse)
    from tpuslam_torch.optim import device as dev
    pose_arr, e_from, e_to, Z, Omega, free_idx = arrays
    V, it = len(pose_arr), DIST_PG_ITERS
    xsel, xp, xq = dev.classify_extra_edges(e_from, e_to, free_idx)
    ef, et, Zp, Op = pad_edges(e_from, e_to, Z, Omega, mesh.size)
    xsel_p = np.full(len(ef), -1, np.int32)
    xsel_p[:len(xsel)] = xsel
    dense, l_d, p_d, w_d = timed(lambda: sharded_pose_graph_step(
        mesh, V, V - 1, iterations=it)(pose_arr, ef, et, Zp, Op, free_idx),
        warm=True)
    expect_launches("sharded dense step", l_d, p_d, {})
    sparse, l_s, p_s, w_s = timed(lambda: sharded_pose_graph_step_sparse(
        mesh, V - 1, iterations=it)(pose_arr, ef, et, Zp, Op, free_idx,
                                    xsel_p, xp, xq), warm=True)
    expect_launches("sharded sparse step", l_s, p_s, dict(thomas=it))
    return dense, sparse, l_s, dict(dense_s=w_d, sparse_s=w_s)


def dist_backend_part():
    """(b) the sharded dense and sparse pose-graph steps and the sharded
    BA on DIST_SHARDS shards of the card, against lm_solve,
    lm_solve_sparse and ba_solve on the card: within the JAX suite's
    tolerances; K7 launched once per iteration by the sparse step (its
    root solve on global shard 0 alone); the wall of each (after one
    untimed call).  Returns
    (numbers, the sharded runs' launches, the graph, the steps'
    results)."""
    from tpuslam_torch.dist.mesh import (make_mesh, make_sharded_ba_step,
                                         shard_ba_problem)
    from tpuslam_torch.optim import device as dev
    from tpuslam_torch.optim.ba import ba_solve
    arrays = noisy_loop_arrays()
    pose_arr, e_from, e_to, Z, Omega, free_idx = arrays
    V, it = len(pose_arr), DIST_PG_ITERS
    xsel, xp, xq = dev.classify_extra_edges(e_from, e_to, free_idx)

    def cu(*a):
        return [torch.as_tensor(x, device="cuda") for x in a]
    graph = cu(pose_arr, e_from, e_to, Z, Omega, free_idx)
    ref, _, _, w_ref = timed(lambda: dev.lm_solve(*graph, V - 1,
                                                  iterations=it), warm=True)
    ref_sp, l_r, p_r, w_rsp = timed(lambda: dev.lm_solve_sparse(
        *graph, V - 1, *cu(xsel, xp, xq), iterations=it), warm=True)
    expect_launches("lm_solve_sparse", l_r, p_r, dict(thomas=it))
    mesh = make_mesh(DIST_SHARDS, axis="edges")
    dense, sparse, launches, walls = dist_backend_runs(mesh, arrays)
    errs = dict(dense=hold_pg("sharded dense vs lm_solve", dense, ref),
                sparse=hold_pg("sharded sparse vs lm_solve_sparse", sparse,
                               ref_sp),
                sparse_dense=hold_pg("sharded sparse vs lm_solve", sparse,
                                     ref))

    p = DIST_BA
    intr, Tcw0, lms0, oc, ol, uv, ov = ba_problem(p["W"], p["L"], p["O"],
                                                  p["seed"])
    (bT, _, bc), _, _, w_ba = timed(lambda: ba_solve(
        *cu(Tcw0, lms0, intr, oc, ol, uv, ov), n_cams=p["W"], n_lms=p["L"],
        iterations=p["iterations"], huber_delta=p["huber_delta"]),
        warm=True)
    lms_p, oc_p, ol_p, uv_p, ov_p, L_local, _ = shard_ba_problem(
        lms0, oc, ol, uv, ov, DIST_SHARDS)
    (sT, _, sc), l_b, p_b, w_sba = timed(lambda: make_sharded_ba_step(
        make_mesh(DIST_SHARDS, axis="landmarks"), p["W"], L_local,
        iterations=p["iterations"], huber_delta=p["huber_delta"])(
        Tcw0, lms_p, intr, oc_p, ol_p, uv_p, ov_p), warm=True)
    expect_launches("sharded BA", l_b, p_b, {})
    dcost = abs(float(sc) - float(bc)) / float(bc)
    dtb = float((sT - bT)[:, :3, 3].abs().max())
    if not (dcost <= DIST_BA_TOL["cost"] and dtb <= DIST_BA_TOL["t"]):
        raise AssertionError(f"sharded BA vs ba_solve: cost rel diff "
                             f"{dcost}, translation diff {dtb} m beyond "
                             f"{DIST_BA_TOL}")
    res = dict(lm_solve_s=w_ref, lm_solve_sparse_s=w_rsp,
               sharded_dense_s=walls["dense_s"],
               sharded_sparse_s=walls["sparse_s"], ba_solve_s=w_ba,
               sharded_ba_s=w_sba, chi2_last=float(sparse[1][-1]),
               chi2_rel_diff={k: v[0] for k, v in errs.items()},
               t_diff_m={k: v[1] for k, v in errs.items()},
               ba_cost=float(sc), ba_cost_rel_diff=dcost, ba_t_diff_m=dtb)
    log(f"# multi-device (b) a {V}-vertex loop graph with a forward "
        f"closure, {DIST_PG_ITERS} LM iterations: lm_solve {w_ref:.4f} s, "
        f"lm_solve_sparse {w_rsp:.4f} s, sharded dense on {DIST_SHARDS} "
        f"shards {walls['dense_s']:.4f} s, sharded sparse "
        f"{walls['sparse_s']:.4f} s (K7 {launches['thomas']} launches, one "
        f"per iteration); chi2 rel diffs {res['chi2_rel_diff']}, "
        f"translation diffs {res['t_diff_m']} m (tolerance {DIST_PG_TOL}); "
        f"BA W={p['W']} L={p['L']} O={p['O']}: ba_solve {w_ba:.4f} s, "
        f"sharded {w_sba:.4f} s, cost {float(sc):.4f} (rel diff "
        f"{dcost:.2e}), translations within {dtb:.2e} m")
    return res, launches, arrays, (dense, sparse)


def _run_all(cmds, workdir, tag):
    """Start every command at once (from the repository root), wait for
    all, each within DIST_TIMEOUT_S; returns each one's wall from the
    common start.  Kills them all and raises if one fails."""
    import os
    import subprocess as sp
    root = os.path.dirname(os.path.abspath(__file__))
    logs = [os.path.join(workdir, f"{tag}_{i}.log") for i in range(len(cmds))]
    t0 = time.perf_counter()
    procs = []
    for c, path in zip(cmds, logs):
        with open(path, "w") as f:
            procs.append(sp.Popen(c, cwd=root, stdout=f, stderr=sp.STDOUT))
    walls = [None] * len(procs)
    try:
        while None in walls:
            if time.perf_counter() - t0 > DIST_TIMEOUT_S:
                raise AssertionError(f"{tag}: a process ran past "
                                     f"{DIST_TIMEOUT_S} s")
            for i, p in enumerate(procs):
                if walls[i] is None and p.poll() is not None:
                    walls[i] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, path in zip(cmds, procs, logs):
        if p.returncode != 0:
            with open(path) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"{' '.join(c)} exited {p.returncode}:\n"
                                 f"{tail}")
    return walls


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_processes_part(seq, workdir):
    """(c) two gloo ranks on the one card through
    tpuslam_torch/tools/dist_worker.py over phase 10's sequence, a
    one-process run of the same worker and cli/slam_multihost.py as two
    gloo ranks, all five processes at once (each one's wall from the
    common start): both ranks' VO and optimised
    poses equal; the VO poses, the partitioned mapper's words, links and
    link transforms equal the one-process run's bit for bit; the ranks'
    words disjoint and complementary (even / odd ids) and each with
    feature bytes; the partitioned mapper's words, links and transforms
    equal the single-process Mapper's bit for bit and its likelihoods to
    rtol 1e-12; at least one loop closure; the global mesh's pose graph
    makes progress (chi2 falls), K7 on rank 0 only; no worker builds a
    kernel library (the build phase did, they load them); the sharded
    dictionary top-2 on it equals one unsharded search (its CUDA
    all-gathers through the host for gloo, counted); every part's kernels
    on the card, no plain version; the CLI's two ranks' poses equal.
    Returns (numbers, the two ranks' launches summed, the one process's
    launches)."""
    import os
    worker = [sys.executable, "-m", "tpuslam_torch.tools.dist_worker", seq]
    d2, d1, dc = (os.path.join(workdir, k) for k in ("dist2", "dist1",
                                                     "dist_cli"))
    wc, cc = f"localhost:{_free_port()}", f"localhost:{_free_port()}"
    cmds = [worker + [d2, wc, "2", str(r), "--backend", "gloo"]
            for r in range(2)] + [worker + [d1, "-", "1", "0"]]
    cmds += [[sys.executable, "-m", "tpuslam_torch.cli.slam_multihost", seq,
              "-coord", cc, "-num-procs", "2", "-rank", str(r), "-out", dc,
              "-quiet", "-backend", "gloo"] for r in range(2)]
    walls = _run_all(cmds, workdir, "dist")
    r = [np.load(os.path.join(d2, f"rank{i}.npz")) for i in range(2)]
    one = np.load(os.path.join(d1, "rank0.npz"))

    def js(z, k):
        return json.loads(str(z[k]))

    def same(what, a, b):
        if not np.array_equal(a, b):
            raise AssertionError(f"multi-device (c): {what} differ")
    for k in ("poses", "opt_poses", "chis", "sp_opt_poses", "sp_chis",
              "pm_lik", "pm_words", "pm_links", "pm_link_tfs"):
        same(f"the two ranks' {k}", r[0][k], r[1][k])
    same("the VO poses of two ranks and of one process", r[0]["poses"],
         one["poses"])
    for k in ("pm_words", "pm_links", "pm_link_tfs"):
        same(f"{k} of two ranks and of one process", r[0][k], one[k])
        same(f"the partitioned and the single-process mapper's {k[3:]}",
             r[0][k], r[0]["sm_" + k[3:]])
    same("likelihood queries", r[0]["pm_lik_cands"], r[0]["sm_lik_cands"])
    if not np.allclose(r[0]["pm_lik"], r[0]["sm_lik"], rtol=1e-12,
                       atol=1e-14) or not r[0]["pm_lik"].size:
        raise AssertionError("multi-device (c): likelihoods differ")
    w0, w1 = (set(z["owned_words"].tolist()) for z in r)
    if w0 & w1 or len(w0) + len(w1) != int(r[0]["total_words"]) or \
            any(w % 2 for w in w0) or not all(w % 2 for w in w1):
        raise AssertionError("multi-device (c): owned words not disjoint "
                             "and complementary by parity")
    if min(int(z["owned_feat_bytes"]) for z in r) <= 0:
        raise AssertionError("multi-device (c): a rank holds no features")
    if int(r[0]["n_lc_pm"]) < 1 or int(r[0]["n_lc_pm"]) != \
            int(r[0]["n_lc_sm"]):
        raise AssertionError(f"multi-device (c): loop closures "
                             f"{int(r[0]['n_lc_pm'])} (single-process "
                             f"{int(r[0]['n_lc_sm'])})")
    for k in ("chis", "sp_chis"):
        if not (np.isfinite(r[0][k]).all() and r[0][k][-1] < r[0][k][0]):
            raise AssertionError(f"multi-device (c): {k} {r[0][k]}")
    if int(r[0]["n_devices"]) != 4 or str(r[0]["backend"]) != "gloo":
        raise AssertionError("multi-device (c): not a 2 x 2 gloo mesh")
    same("the ranks' dictionary top-2", r[0]["top2_w1"], r[1]["top2_w1"])
    if not all(bool(z["top2_equal"]) for z in r + [one]):
        raise AssertionError("multi-device (c): the sharded dictionary "
                             "top-2 differs from one unsharded search")
    n = len(r[0]["poses"])
    sizes = [n - n // 2, n // 2]
    chunk = 30
    for i, z in enumerate(r + [one]):
        if any(js(z, "built_s").values()):
            raise AssertionError(f"multi-device (c): a worker built a "
                                 f"kernel library: {js(z, 'built_s')}")
    for i, z in enumerate(r):
        la, pl = js(z, "launches"), js(z, "plain")
        if any(v for part in pl.values() for v in part.values()):
            raise AssertionError(f"multi-device (c): rank {i} ran a plain "
                                 f"version: {pl}")
        batches = -(-sizes[i] // chunk)
        fe = {k: la["vo"][k] for k in ("stereo_bm", "lr_check", "gftt",
                                       "orb")}
        if fe != dict.fromkeys(fe, batches) or la["vo"]["lm_refine"] < 1 \
                or la["vo"]["median"]:
            raise AssertionError(f"multi-device (c): rank {i}'s VO "
                                 f"launches {la['vo']}")
        if la["pose_graph"]["thomas"] != (DIST_PG_ITERS if i == 0 else 0):
            raise AssertionError(f"multi-device (c): rank {i}'s K7 "
                                 f"launches {la['pose_graph']}")
    p0, p1 = (np.loadtxt(os.path.join(dc, f"poses_rank{i}.txt"))
              for i in range(2))
    same("the CLI's two ranks' poses", p0, p1)
    cli = []
    for i in range(2):
        with open(os.path.join(dc, f"result_rank{i}.json")) as f:
            cli.append(json.load(f))
    if p0.shape != (n, 12) or cli[0]["n_frames"] != n:
        raise AssertionError(f"multi-device (c): the CLI wrote {p0.shape}")

    def total(z):
        la = js(z, "launches")
        return {k: sum(part[k] for part in la.values()) for k in la["vo"]}
    two = {k: total(r[0])[k] + total(r[1])[k] for k in total(r[0])}
    res = dict(
        walls_s=dict(rank0=walls[0], rank1=walls[1], one_process=walls[2],
                     cli_rank0=walls[3], cli_rank1=walls[4]),
        parts_s={f"rank{i}": js(z, "seconds") for i, z in enumerate(r)} |
        dict(one_process=js(one, "seconds")),
        map_bytes={f"rank{i}": js(z, "map_bytes") for i, z in enumerate(r)}
        | dict(one_process=js(one, "map_bytes")),
        cli_map_bytes=[c["map_bytes"] for c in cli],
        collectives=js(r[0], "collectives"),
        loop_closures=int(r[0]["n_lc_pm"]), words=int(r[0]["total_words"]),
        cli_loop_closures=cli[0]["n_loop_closures"])
    log(f"# multi-device (c) two gloo ranks on one card over {n} frames "
        f"{WIDTH}x{HEIGHT} (tools/dist_worker.py), a one-process run and "
        f"the CLI's two ranks, five processes at once: walls "
        f"{json.dumps({k: round(v, 3) for k, v in res['walls_s'].items()})}"
        f" s; per part {json.dumps(res['parts_s'])}; map bytes per rank "
        f"{json.dumps(res['map_bytes'])}; CLI "
        f"{json.dumps(res['cli_map_bytes'])}"
        f"; rank 0's collectives {json.dumps(res['collectives'])} (the "
        f"top-2's CUDA all-gathers through the host for gloo: "
        f"{res['collectives']['dict_top2']['host_hop']}); "
        f"{res['loop_closures']} loop closures, {res['words']} words; every "
        f"equality held")
    return res, two, total(one)


NCCL_PAIR = ("import sys, torch, torch.distributed as d; "
             "torch.cuda.set_device(0); "
             "d.init_process_group('nccl', init_method='tcp://' + sys.argv[1],"
             " world_size=2, rank=int(sys.argv[2])); "
             "x = torch.ones(4, device='cuda'); d.all_reduce(x); "
             "torch.cuda.synchronize(); print('reduced', x.tolist()); "
             "d.destroy_process_group()")


def dist_nccl_part(arrays, results, workdir):
    """(d) one NCCL rank (init_process_group("nccl", world_size=1)): the
    dense and sparse steps on a mesh of DIST_SHARDS shards with their
    collectives through NCCL on the card, equal to (b)'s one-process
    results within DIST_PG_TOL; then two NCCL ranks on the one card,
    each within 60 s, which NCCL is expected to refuse ("Duplicate GPU
    detected"): what it did is printed, not asserted."""
    import os
    import subprocess as sp
    import torch.distributed as dist
    from tpuslam_torch.dist import mesh as M
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = M.make_mesh(DIST_SHARDS, axis="edges")
        if mesh.group is None or dist.get_backend() != "nccl":
            raise AssertionError("multi-device (d): no NCCL group")
        M.reset_collectives()
        dense, sparse, launches, walls = dist_backend_runs(mesh, arrays)
        coll = dict(M.COLLECTIVES)
    finally:
        dist.destroy_process_group()
    # per step and iteration: the system's sum and max and chi2's sum,
    # and the sparse step's broadcast; each step ran warm, then timed
    want = dict(all_reduce=2 * 2 * 3 * DIST_PG_ITERS,
                broadcast=2 * DIST_PG_ITERS, all_gather=0, host_hop=0)
    if coll != want:
        raise AssertionError(f"multi-device (d): collectives {coll}, "
                             f"expected {want}")
    errs = (hold_pg("one NCCL rank, dense", dense, results[0]),
            hold_pg("one NCCL rank, sparse", sparse, results[1]))
    coord = f"localhost:{_free_port()}"
    logs = [os.path.join(workdir, f"nccl_pair_{i}.log") for i in range(2)]
    procs = []
    for i, path in enumerate(logs):
        with open(path, "w") as f:
            procs.append(sp.Popen([sys.executable, "-c", NCCL_PAIR, coord,
                                   str(i)], stdout=f, stderr=sp.STDOUT))
    t0 = time.perf_counter()
    for p in procs:
        try:
            p.wait(timeout=max(1.0, 60 - (time.perf_counter() - t0)))
        except sp.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    out = []
    for p, path in zip(procs, logs):
        with open(path) as f:
            text = f.read()
        dup = "Duplicate GPU" in text
        out.append(dict(rc=p.returncode, duplicate_gpu=dup,
                        reduced="reduced" in text))
    log(f"# multi-device (d) one NCCL rank: dense {walls['dense_s']:.4f} s"
        f", sparse {walls['sparse_s']:.4f} s (K7 {launches['thomas']}), "
        f"collectives {coll}, chi2 rel diff / translation diff to (b) "
        f"{errs}; two NCCL ranks on one card: {out}")
    return dict(walls, collectives=coll, nccl_pair=out)


def multi_device_phase(rows, lefts, rights, seq, workdir):
    """Phase 16, the multi-device layer on the card: (a)-(d).  Adds each
    kernel's launches in (a), (b) and (c) to its row (`dist`)."""
    from tpuslam_torch.kernels import _cuda
    t0 = time.perf_counter()
    fe, l_a = dist_frontend_part(lefts, rights)
    be, l_b, arrays, results = dist_backend_part()
    pr, l_two, l_one = dist_processes_part(seq, workdir)
    nc = dist_nccl_part(arrays, results, workdir)
    for k in _cuda.ALL:
        if k in rows:
            rows[k]["dist"] = dict(sharded_frontend=l_a[k],
                                   sharded_backend=l_b[k],
                                   two_ranks=l_two[k], one_process=l_one[k])
    took = time.perf_counter() - t0
    log(f"# multi-device: phase 16 took {took:.2f} s")
    return dict(frontend=fe, backend=be, processes=pr, nccl=nc,
                seconds=took)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spread", type=int, default=0)
    ap.add_argument("--parent", help="a parent tree (unpacked): phase 14 "
                    "times K7 and the device back end in turns with its")
    args = ap.parse_args()
    smi = device_phase()
    import tpuslam_torch  # noqa: F401  (applies the precision pin)
    from tpuslam_torch.kernels import _cuda
    from tpuslam_torch.config import DepthMethod, SlamConfig
    from tpuslam_torch.io import native_loader
    from tpuslam_torch.io.synthetic import make_sequence, sequence_camera
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    from tpuslam_torch.tools.timing import floor_ms

    t0 = time.perf_counter()
    took = _cuda.build_all()
    for name in _cuda.ALL:
        _cuda.launcher(name)
    t1 = time.perf_counter()
    native_loader.get_lib()
    log(f"# build: {t1 - t0:.2f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())}); "
        f"native decoder (g++) {time.perf_counter() - t1:.2f} s")

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
    k1_wide_phase(rows, *chunk)
    items = [dict(left=lefts[i], right=rights[i], stamp=stamps[i],
                  ground_truth=gt[i]) for i in range(N_FRAMES)]
    staged = FastSlamPipeline(camera, cfg, chunk=CHUNK,
                              capacity=CAPACITY).stage_chunks(items)
    mapper, launches, fps, frame1_args, infos = main_path_phase(
        camera, cfg, staged, items, gt)
    lm_phase(rows, frame1_args, camera, cfg)
    post_loop_phase(mapper, camera, cfg, gt)
    slice_fps = slice_phase(camera, staged, items, gt)
    speckle_check(*chunk, cfg)
    depth = depth_engines_phase(lefts, rights, camera)
    sgbm_fps, sgbm_peak = sgbm_main_path_phase(camera, staged, items, gt)
    with tempfile.TemporaryDirectory() as workdir:
        ingest_fps = ingest_phase(workdir, camera, cfg, lefts, rights,
                                  stamps, gt, staged, items, infos, fps)
        seq, pf_res, pf_launches = per_frame_phase(workdir, rows)
        pf_fps = pf_res["fps"]
        rt = realtime_phase(seq, workdir)
        backend_phase(seq, workdir, pf_res, rows)
        backend_scale_phase(rows, args.parent)
        tools = tool_apps_phase(workdir, rows)
        multi = multi_device_phase(rows, lefts, rights, seq, workdir)
        log(f"# fps: default configuration + Mapper {fps:.3f}, the same "
            f"from PNG files (run_ingest) {ingest_fps:.3f}, slice "
            f"{slice_fps:.3f}, per-frame batch path {pf_fps:.3f}, SGBM main "
            f"path {sgbm_fps:.3f} (peak {sgbm_peak:.1f} MiB), realtime " +
            ", ".join(f"{m} {v[0]:.3f} (p50 {v[1]:.2f} ms, p95 {v[2]:.2f} "
                      f"ms)" for m, v in rt.items()))
        log("# per-frame path launches per kernel: " + json.dumps(
            {k: pf_launches[k] for k in _cuda.KERNELS}))
        log("# depth engines: " + json.dumps(depth))
        log("# tool apps: " + json.dumps(tools))
        log("# multi-device: " + json.dumps(multi))
        if args.spread:
            pf_spread_phase(seq, workdir, args.spread)
            realtime_spread_phase(seq, workdir, args.spread)
            real_texture_spread(args.spread)
    if args.spread:
        spread_phase(camera, cfg, staged, items, gt, args.spread)
        spread_phase(camera, SlamConfig(depth_method=DepthMethod.SGBM),
                     staged, items, gt, args.spread, what="SGBM ")

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
        "library_ms", "via", "tool_launches", "phases", "shape", "wide",
        "per_frame", "per_frame_loop_closure", "tool_apps", "dist",
        "launches_scale", "n", "m", "bit_equal", "step_us", "forward_ms",
        "backward_ms", "chain_ms", "at_cut", "at_4541", "backend_s",
        "turns")
        if k in rows[n]}
        for n in _cuda.ALL]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
