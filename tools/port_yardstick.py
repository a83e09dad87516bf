"""Yardstick for the PyTorch port: tpuslam (JAX, here on the CPU) running
what bench.py runs, on bench.py's sequence, with quality metrics only.

    JAX_PLATFORMS=cpu python tools/port_yardstick.py [--chunk 5] [--slice]

Default: SlamConfig() as it stands, a Mapper with async loop closure and
the per-chunk device dictionary, then the robust pose graph and global BA
(bench.py:97-239).  --slice runs the first port slice's configuration
(no left-right check, no LM refine) and no Mapper.  The trajectory does
not depend on the chunk size; a small chunk bounds host memory (~4 GB at
chunk 5).  Prints one JSON line of metrics (no timing: a CPU run says
nothing about the device).
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=5)
    ap.add_argument("--slice", action="store_true")
    args = ap.parse_args()

    import bench
    from tpuslam.config import SlamConfig, StereoBMConfig, PnPConfig
    from tpuslam.geometry.camera import StereoCameraModel
    from tpuslam.geometry.kitti_metric import calc_kitti_sequence_errors
    from tpuslam.io.dataset import StereoImageDataset
    from tpuslam.mapping.mapper import Mapper
    from tpuslam.mapping.ba_window import refine_trajectory_global_ba
    from tpuslam.optim import run_optimize_robust
    from tpuslam.runtime.fast_pipeline import FastSlamPipeline

    seq = bench.ensure_sequence()
    cfg = SlamConfig()
    if args.slice:
        cfg = cfg.replace(bm=StereoBMConfig(disp12_max_diff=-1),
                          pnp=PnPConfig(refine_iterations=0))
    camera = StereoCameraModel.load_kitti(
        os.path.join(seq, "calib.txt"), image_size=(1241, 376))
    ds = StereoImageDataset(
        left_dir=os.path.join(seq, "image_0"),
        right_dir=os.path.join(seq, "image_1"),
        times_path=os.path.join(seq, "times.txt"),
        gt_path=os.path.join(seq, "poses.txt"))
    items = [ds[i] for i in range(min(bench.N_FRAMES, len(ds)))]

    pipe = FastSlamPipeline(camera, cfg, chunk=args.chunk, capacity=1536)
    staged = pipe.stage_chunks(items)
    mapper = None
    if not args.slice:
        mapper = Mapper(camera, cfg.mapper, cfg.matching, cfg.pnp)
        mapper.async_lc = True
    infos = pipe.run_staged(staged, items, mapper=mapper,
                            mapper_async=mapper is not None)

    est = np.stack([i.pose for i in infos])
    gt = np.stack([np.vstack([it["ground_truth"], [0, 0, 0, 1]])
                   if it["ground_truth"].shape == (3, 4)
                   else it["ground_truth"] for it in items])
    inl = sorted(i.num_inliers for i in infos[1:])
    t_err, r_err = calc_kitti_sequence_errors(gt, est)
    out = dict(config="slice" if args.slice else "SlamConfig()+Mapper",
               frames=len(items), chunk=pipe.chunk,
               lost=sum(1 for i in infos[1:] if i.lost),
               median_inliers=inl[len(inl) // 2], min_inliers=inl[0],
               ate_m=float(np.sqrt(np.mean(np.sum(
                   (est[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=1)))),
               t_err_pct=t_err, r_err_deg_per_m=r_err)
    if mapper is not None:
        poses, links = mapper.get_graph()
        out.update(nodes=len(mapper.nodes), graph_links=len(links),
                   loop_closures=len(mapper.loop_closures),
                   words=mapper.vwd._count)
        optimized, _ = run_optimize_robust(poses, links, 20, cfg.optimizer)
        ba_poses = refine_trajectory_global_ba(mapper, optimized, camera)
        ids = sorted(optimized)
        gt_n = gt[[i - 1 for i in ids]]
        for name, pd in (("posegraph", optimized), ("ba", ba_poses)):
            est_n = np.stack([pd[i] for i in ids])
            te, re_ = calc_kitti_sequence_errors(gt_n, est_n)
            out[f"{name}_ate_m"] = float(np.sqrt(np.mean(np.sum(
                (est_n[:, :3, 3] - gt_n[:, :3, 3]) ** 2, axis=1))))
            out[f"{name}_t_err_pct"] = te
            out[f"{name}_r_err_deg_per_m"] = re_
    print(json.dumps(out))


if __name__ == "__main__":
    main()
