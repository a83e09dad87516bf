"""Streaming SLAM mode (the reference's SLAM_REALTIME app).

Counterpart of tpuslam/cli/slam_realtime.py.  The reference's realtime
mode (main.cpp:81-308, SURVEY.md §3.2) pipelines three compute domains:
the PL computes frame N+1's disparity/eigenvalue maps into double-banked
DDR while the A53 runs VO/mapping on frame N, with loop closure on a
worker thread.  Here, domain by domain:

  PL vision pipeline    -> frame i+1's frontend_dispatch, queued on the
                           device before frame i is collected
  double-banked DDR     -> the pending dispatch's device tensors + the
                           native prefetch ring's frame banks
                           (StereoImageDataset.prefetch_iter)
  A53 worker LC thread  -> Mapper.async_lc worker thread

The back end (odometry, mapper, post-loop optimization) is slam_batch's,
as in the reference, where both app modes share the SLAM core.  Device
work runs on `device`, the card unless the caller asks for the CPU:

    python -m tpuslam_torch.cli.slam_realtime -dir DIR [-n N] [-out OUT]
        [-quiet] [-no-pipeline] [-no-async-lc] [-telemetry DIR]
        [-depth bm|sgbm|lk|cv_bm] [-device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..config import DepthMethod, SlamConfig
from ..geometry.camera import StereoCameraModel
from ..geometry.kitti_metric import ate_rmse, calc_kitti_sequence_errors
from ..io.dataset import StereoImageDataset, save_poses
from ..io.png import image_size as png_size
from ..mapping.mapper import Mapper
from ..optim import run_optimize_robust
from ..runtime.perf import Perf
from ..runtime.pipeline import (extract_features, frontend_collect,
                                frontend_dispatch)
from ..vo.odometry import Odometry


def run(seq_dir: str, cfg: SlamConfig | None = None,
        num_images: int = -1, out_dir: str | None = None,
        image_size: tuple[int, int] | None = None, quiet: bool = False,
        pipelined: bool = True, async_lc: bool = True,
        telemetry_dir: str | None = None, device="cuda",
        draws_fn=None) -> dict:
    """Run the streaming pipeline over a KITTI-layout sequence directory
    on `device`.  `draws_fn(seed)`, when set, supplies the RANSAC uniforms
    of every registration (tests pass tpuslam's).  Returns tpuslam's
    result dict: fps, latency_ms_p50/p95, vo_poses, optimized, ..."""
    cfg = cfg or SlamConfig()
    out_dir = out_dir or seq_dir
    os.makedirs(out_dir, exist_ok=True)

    telemetry = None
    if telemetry_dir:
        # live rect/disparity frame ring, the UVC-stream analog
        # (xusb_main.c:166-199); opt-in and off the critical path
        from ..runtime.telemetry import TelemetrySink
        telemetry = TelemetrySink(telemetry_dir)

    left_dir = os.path.join(seq_dir, "image_0")
    right_dir = os.path.join(seq_dir, "image_1")
    gt = os.path.join(seq_dir, "poses.txt")
    ds = StereoImageDataset(
        left_dir=left_dir, right_dir=right_dir,
        times_path=os.path.join(seq_dir, "times.txt"),
        gt_path=gt if os.path.exists(gt) else None)
    if image_size is None:
        # the first image's geometry, from its PNG header
        image_size = png_size(os.path.join(left_dir, ds._left[0]))
    camera = StereoCameraModel.load_kitti(
        os.path.join(seq_dir, "calib.txt"), do_resize=cfg.do_resize,
        image_size=image_size)

    odom = Odometry(camera, cfg.odometry, cfg.matching, cfg.pnp,
                    device=device, draws_fn=draws_fn)
    mapper = Mapper(camera, cfg.mapper, cfg.matching, cfg.pnp,
                    device=device)
    mapper.draws_fn = draws_fn
    mapper.async_lc = async_lc
    perf = Perf()

    n = len(ds) if num_images < 0 else min(num_images + 1, len(ds))
    items = ds.prefetch_iter(0, n)

    latencies = []
    t_start = time.time()
    pending = None
    pending_meta = None
    vo_poses = []
    for i in range(n + 1):
        # queue frame i's device work while frame i-1 is finished on the
        # host
        if i < n:
            item = next(items)
            disp_next = frontend_dispatch(item["left"], item["right"], cfg,
                                          device) if pipelined else item
            meta_next = (i, item)
        else:
            disp_next, meta_next = None, None

        if pending is not None:
            j, itm = pending_meta
            t0 = time.perf_counter()
            perf.set_frame(j)
            with perf.span("frontend.collect"):
                if pipelined:
                    frame = frontend_collect(
                        pending, camera, cfg, stamp=itm["stamp"],
                        frame_id=j, gt_pose=itm["ground_truth"])
                else:
                    frame = extract_features(
                        itm["left"], itm["right"], camera, cfg,
                        stamp=itm["stamp"], frame_id=j,
                        gt_pose=itm["ground_truth"], device=device)
            with perf.span("odom.process"):
                info = odom.process(frame)
            with perf.span("mapper.process"):
                mapper.process(frame, info)
            if telemetry is not None:
                telemetry.publish(j, itm["stamp"], left=itm["left"],
                                  disparity=frame.disparity)
            vo_poses.append(info.pose)
            latencies.append(time.perf_counter() - t0)
            if not quiet:
                print(f"frame {j}/{n - 1} inliers: {frame.n_kpts}/"
                      f"{info.num_matches}/{info.num_inliers}"
                      f"{' LOST' if info.lost else ''}")
        pending, pending_meta = disp_next, meta_next
    elapsed = time.time() - t_start
    mapper.join_loop_closure()
    if telemetry is not None:
        telemetry.close()

    poses, links = mapper.get_graph()
    optimized, chi2 = run_optimize_robust(poses, links,
                                          cfg.optimizer.final_iterations,
                                          cfg.optimizer)
    save_poses(os.path.join(out_dir, "optimized_poses.csv"), optimized)

    lat = np.array(latencies[1:]) if len(latencies) > 1 else \
        np.array(latencies)
    result = {
        "n_frames": n, "elapsed_s": elapsed, "fps": n / elapsed,
        "latency_ms_p50": float(np.percentile(lat, 50) * 1e3),
        "latency_ms_p95": float(np.percentile(lat, 95) * 1e3),
        "vo_poses": np.stack(vo_poses), "optimized": optimized,
        "chi2": chi2, "mapper": mapper,
        "n_loop_closures": len(mapper.loop_closures),
    }
    if telemetry is not None:
        result["telemetry"] = telemetry.stats
    gt_list, opt_list = [], []
    for nid in sorted(optimized):
        node = mapper.nodes.get(nid)
        if node is not None and node.frame.gt_pose is not None:
            gt_list.append(node.frame.gt_pose)
            opt_list.append(optimized[nid])
    if gt_list:
        gt_arr, opt_arr = np.stack(gt_list), np.stack(opt_list)
        t_err, r_err = calc_kitti_sequence_errors(gt_arr, opt_arr)
        result.update(t_err_pct=t_err, r_err_deg_per_m=r_err,
                      ate_m=ate_rmse(gt_arr, opt_arr))
    if not quiet:
        print(f"realtime: {result['fps']:.2f} fps, "
              f"p50 {result['latency_ms_p50']:.1f} ms, "
              f"p95 {result['latency_ms_p95']:.1f} ms")
    perf.write(os.path.join(out_dir, "perf_time.csv"))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="tpuslam_torch streaming mode (SLAM_REALTIME twin)")
    ap.add_argument("-dir", dest="dir", required=True)
    ap.add_argument("-n", dest="num_images", type=int, default=-1)
    ap.add_argument("-out", dest="out_dir", default=None)
    ap.add_argument("-quiet", action="store_true")
    ap.add_argument("-no-pipeline", dest="pipelined",
                    action="store_false")
    ap.add_argument("-no-async-lc", dest="async_lc",
                    action="store_false")
    ap.add_argument("-telemetry", dest="telemetry_dir", default=None,
                    help="live rect/disparity frame-ring directory "
                         "(UVC stream analog, xusb_main.c:166-199)")
    ap.add_argument("-depth", dest="depth", default="bm",
                    choices=[m.value for m in DepthMethod],
                    help="depth engine (appSetting.depthMethod twin, "
                         "Parameters.h:24-30)")
    ap.add_argument("-device", dest="device", default="cuda",
                    help="torch device of the device work (default: the "
                         "card)")
    a = ap.parse_args(argv)
    run(a.dir, cfg=SlamConfig(depth_method=DepthMethod(a.depth)),
        num_images=a.num_images, out_dir=a.out_dir, quiet=a.quiet,
        pipelined=a.pipelined, async_lc=a.async_lc,
        telemetry_dir=a.telemetry_dir, device=a.device)


if __name__ == "__main__":
    main()
