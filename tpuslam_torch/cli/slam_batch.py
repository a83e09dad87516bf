"""SLAM batch mode: KITTI-style directory in, trajectory + metrics out.

Counterpart of tpuslam/cli/slam_batch.py (the reference's SLAM_BATCH app,
main.cpp:52-380): per-frame front end (runtime/pipeline.py) + Odometry +
Mapper with loop closure, post-loop robust pose-graph optimization,
optimized-poses CSV, KITTI ground-truth scoring and the occupancy grid
(slam.bt).  Device work runs on `device`, the card unless the caller asks
for the CPU:

    python -m tpuslam_torch.cli.slam_batch -dir DIR [-n N] [-out OUT]
        [-depth bm|sgbm|lk|cv_bm] [-device cuda|cpu] [-device-opt]
        [-checkpoint-every N [-checkpoint PATH] | -resume PATH]

`-depth bm|sgbm|lk|cv_bm` picks the depth engine (runtime/pipeline.py).
`-device-opt` runs the post-loop pose graph's LM on `device`
(optim/device.py: the block-Thomas solve, kernel K7 on the card) instead
of the host twin.  `-checkpoint-every N` saves the Mapper and odometry
state (runtime/checkpoint.py) every N frames, to `-checkpoint` or
OUT/checkpoint.npz; `-resume PATH` continues a run from such a file.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..config import DepthMethod, SlamConfig
from ..geometry.camera import StereoCameraModel
from ..geometry.kitti_metric import calc_kitti_sequence_errors, ate_rmse
from ..io.dataset import StereoImageDataset, save_poses, save_links
from ..io.png import image_size as png_size
from ..mapping.mapper import Mapper
from ..optim import run_optimize_robust
from ..runtime.perf import Perf
from ..runtime.pipeline import extract_features
from ..vo.odometry import Odometry


def run(seq_dir: str, cfg: SlamConfig | None = None,
        num_images: int = -1, out_dir: str | None = None,
        image_size: tuple[int, int] | None = None,
        quiet: bool = False, memory: bool = False,
        resume_from: str | None = None,
        checkpoint_every: int = 0,
        checkpoint_path: str | None = None,
        ba: bool = False, ba_global: bool = False,
        opt_backend: str = "host", device="cuda",
        draws_fn=None) -> dict:
    """Run the batch pipeline over a KITTI-layout sequence directory on
    `device`.  `draws_fn(seed)`, when set, supplies the RANSAC uniforms of
    every registration (tests pass tpuslam's).  `opt_backend` is the pose
    graph's ("host", "device" or "device-dense", optim/pose_graph.py);
    `resume_from` a checkpoint to continue from; with `checkpoint_every`
    the state is saved every that many frames.

    Returns a result dict with raw/optimized poses, metrics, and timing.
    """
    cfg = cfg or SlamConfig()
    out_dir = out_dir or seq_dir
    os.makedirs(out_dir, exist_ok=True)

    left_dir = os.path.join(seq_dir, "image_0")
    right_dir = os.path.join(seq_dir, "image_1")
    calib = os.path.join(seq_dir, "calib.txt")
    times = os.path.join(seq_dir, "times.txt")
    gt = os.path.join(seq_dir, "poses.txt")

    ds = StereoImageDataset(left_dir=left_dir, right_dir=right_dir,
                            times_path=times,
                            gt_path=gt if os.path.exists(gt) else None)
    if image_size is None:
        # the first image's geometry (the reference hardcodes KITTI's)
        image_size = png_size(os.path.join(left_dir, ds._left[0]))
    camera = StereoCameraModel.load_kitti(calib, do_resize=cfg.do_resize,
                                          image_size=image_size)

    odom = Odometry(camera, cfg.odometry, cfg.matching, cfg.pnp,
                    device=device, draws_fn=draws_fn)
    mapper = Mapper(camera, cfg.mapper, cfg.matching, cfg.pnp,
                    device=device)
    mapper.draws_fn = draws_fn
    perf = Perf()

    start_frame = 0
    vo_poses = []
    if resume_from:
        from ..runtime.checkpoint import load_state
        load_state(resume_from, mapper, odom)
        start_frame = mapper._frame_processed
        # seed VO trajectory from the stored per-frame node poses
        vo_poses = [mapper.nodes[i].pose
                    for i in sorted(mapper.nodes)][:start_frame]
        if not quiet:
            print(f"resumed from {resume_from} at frame {start_frame}")

    n = len(ds) if num_images < 0 else min(num_images + 1, len(ds))
    t_start = time.time()
    items = ds.prefetch_iter(start_frame, n)
    for i in range(start_frame, n):
        perf.set_frame(i)
        with perf.span("captureImageLR"):
            item = next(items)
        with perf.span("frontend"):
            frame = extract_features(item["left"], item["right"], camera,
                                     cfg, stamp=item["stamp"], frame_id=i,
                                     gt_pose=item["ground_truth"],
                                     device=device)
        with perf.span("odom.process"):
            info = odom.process(frame)
        with perf.span("mapper.process"):
            mapper.process(frame, info)
        vo_poses.append(info.pose)
        if memory and i % 10 == 0:
            # main.cpp:301-304: components self-report every 10 frames
            for name, nbytes in mapper.memory_used().items():
                perf.register_memory(name, nbytes)
            if odom.ref_frame is not None:
                perf.register_memory("Odometry.refFrame",
                                     odom.ref_frame.memory_used())
        if checkpoint_every and (i + 1) % checkpoint_every == 0:
            from ..runtime.checkpoint import save_state
            cp = checkpoint_path or os.path.join(out_dir, "checkpoint.npz")
            with perf.span("checkpoint"):
                save_state(cp, mapper, odom)
        if not quiet:
            print(f"frame {i}/{n - 1} inliers: {frame.n_kpts}/"
                  f"{info.num_matches}/{info.num_inliers}"
                  f"{' LOST' if info.lost else ''}")
    elapsed = time.time() - t_start

    # post-loop: robust pose-graph optimization (main.cpp:317-332); the
    # graph joins a pending loop-closure worker first (async_lc)
    poses, links = mapper.get_graph()
    save_poses(os.path.join(out_dir, "map_poses.csv"), poses)
    save_links(os.path.join(out_dir, "map_links.csv"),
               list(links.values()))
    optimized, chi2 = run_optimize_robust(poses, links,
                                          cfg.optimizer.final_iterations,
                                          cfg.optimizer,
                                          backend=opt_backend, device=device)
    save_poses(os.path.join(out_dir, "optimized_poses.csv"), optimized)

    if ba:
        # windowed bundle adjustment over the optimized keyframes
        from ..mapping.ba_window import refine_trajectory_ba
        with perf.span("bundleAdjustment"):
            optimized = refine_trajectory_ba(mapper, optimized, camera,
                                             device=device)
        save_poses(os.path.join(out_dir, "ba_poses.csv"), optimized)
    elif ba_global:
        # one global solve over all keyframes
        from ..mapping.ba_window import refine_trajectory_global_ba
        with perf.span("bundleAdjustment"):
            optimized = refine_trajectory_global_ba(mapper, optimized,
                                                    camera, device=device)
        save_poses(os.path.join(out_dir, "ba_poses.csv"), optimized)

    # ground-truth comparison (main.cpp:337-363)
    result = {
        "n_frames": n,
        "elapsed_s": elapsed,
        "fps": n / elapsed,
        "vo_poses": np.stack(vo_poses),
        "poses": poses,
        "optimized": optimized,
        "chi2": chi2,
        "n_nodes": len(poses),
        "n_links": len(links),
        "n_loop_closures": len(mapper.loop_closures),
        "mapper": mapper,
    }
    gt_list = []
    opt_list = []
    for nid in sorted(optimized):
        node = mapper.nodes.get(nid)
        if node is not None and node.frame.gt_pose is not None:
            gt_list.append(node.frame.gt_pose)
            opt_list.append(optimized[nid])
    if gt_list:
        gt_arr = np.stack(gt_list)
        opt_arr = np.stack(opt_list)
        t_err, r_err = calc_kitti_sequence_errors(gt_arr, opt_arr)
        result["t_err_pct"] = t_err
        result["r_err_deg_per_m"] = r_err
        result["ate_m"] = ate_rmse(gt_arr, opt_arr)
        if not quiet:
            print(f"KITTI t_err = {t_err:.4f} %")
            print(f"KITTI r_err = {r_err:.6f} deg/m")
            print(f"ATE = {result['ate_m']:.4f} m")

    # occupancy grid map -> slam.bt (main.cpp:495-561)
    with perf.span("buildOccupancyGridMap"):
        from ..mapping3d import build_occupancy_grid_map
        grid = build_occupancy_grid_map(
            mapper, optimized, camera,
            out_path=os.path.join(out_dir, "slam.bt"), device=device)
    result["n_occupied_voxels"] = grid.num_occupied
    if not quiet:
        print(f"occupancy grid: {grid.num_occupied} voxels -> slam.bt")

    perf.write(os.path.join(out_dir, "perf_time.csv"))
    if memory:
        perf.write_memory(os.path.join(out_dir, "perf_memory.csv"))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="tpuslam_torch batch SLAM (reference SLAM_BATCH twin)")
    ap.add_argument("-dir", dest="dir", required=True,
                    help="sequence directory (KITTI layout)")
    ap.add_argument("-n", dest="num_images", type=int, default=-1)
    ap.add_argument("-out", dest="out_dir", default=None)
    ap.add_argument("-quiet", action="store_true")
    ap.add_argument("-memory", action="store_true",
                    help="per-component memory accounting (-memory flag, "
                         "Parameters.cpp)")
    ap.add_argument("-resume", dest="resume_from", default=None,
                    help="checkpoint .npz to resume from")
    ap.add_argument("-checkpoint-every", dest="checkpoint_every",
                    type=int, default=0)
    ap.add_argument("-checkpoint", dest="checkpoint_path", default=None)
    ap.add_argument("-ba", action="store_true",
                    help="windowed bundle adjustment after the pose graph")
    ap.add_argument("-ba-global", dest="ba_global", action="store_true",
                    help="one global bundle adjustment over all "
                         "keyframes after the pose graph")
    ap.add_argument("-device-opt", dest="device_opt", action="store_true",
                    help="run the pose-graph LM on the device "
                         "(optim.device.lm_solve_sparse) instead of the "
                         "host twin")
    ap.add_argument("-depth", dest="depth", default="bm",
                    choices=[m.value for m in DepthMethod],
                    help="depth engine (appSetting.depthMethod twin, "
                         "Parameters.h:24-30)")
    ap.add_argument("-device", dest="device", default="cuda",
                    help="torch device of the device work (default: the "
                         "card)")
    args = ap.parse_args(argv)
    cfg = SlamConfig(depth_method=DepthMethod(args.depth))
    run(args.dir, cfg=cfg, num_images=args.num_images,
        out_dir=args.out_dir,
        quiet=args.quiet, memory=args.memory,
        resume_from=args.resume_from,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=args.checkpoint_path, ba=args.ba,
        ba_global=args.ba_global,
        opt_backend="device" if args.device_opt else "host",
        device=args.device)


if __name__ == "__main__":
    main()
