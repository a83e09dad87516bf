"""Optimizer stage replay: re-run pose-graph optimization from CSVs.

Counterpart of tpuslam/cli/optimize_replay.py (the reference's offline
replay path: poses/links CSV save/load, Graph.cpp:72-175, hook at
main.cpp:321-325), so the graph-optimization stage re-runs on captured
graphs without the front end.  The host backend only, as tpuslam's:

    python -m tpuslam_torch.cli.optimize_replay -poses map_poses.csv \\
        -links map_links.csv -out optimized_poses.csv [-gt poses.txt]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import OptimizerConfig
from ..io.dataset import load_links, load_poses, save_poses
from ..mapping.graph import MultiMap
from ..optim import run_optimize_robust


def run(poses_path: str, links_path: str, out_path: str | None = None,
        gt_path: str | None = None, iterations: int = 20,
        quiet: bool = False) -> dict:
    poses = load_poses(poses_path)
    link_list = load_links(links_path)
    links = MultiMap()
    for link in link_list:
        links.insert(link.from_id, link)

    optimized, chi2 = run_optimize_robust(poses, links, iterations,
                                          OptimizerConfig())
    if out_path:
        save_poses(out_path, optimized)
    result = {"optimized": optimized, "chi2": chi2,
              "n_poses": len(poses), "n_links": len(link_list)}

    if gt_path:
        from ..geometry.kitti_metric import (ate_rmse,
                                             calc_kitti_sequence_errors)
        from ..io.dataset import import_poses
        gt = import_poses(gt_path)
        ids = sorted(optimized)
        if len(gt) >= len(ids):
            gt_arr = np.stack([gt[i - 1] for i in ids])
            opt_arr = np.stack([optimized[i] for i in ids])
            t_err, r_err = calc_kitti_sequence_errors(gt_arr, opt_arr)
            result.update(t_err_pct=t_err, r_err_deg_per_m=r_err,
                          ate_m=ate_rmse(gt_arr, opt_arr))
    if not quiet:
        print(f"replayed {result['n_poses']} poses / "
              f"{result['n_links']} links, chi2 = {chi2:.6f}")
        if "t_err_pct" in result:
            print(f"KITTI t_err = {result['t_err_pct']:.4f} % "
                  f"r_err = {result['r_err_deg_per_m']:.6f} deg/m "
                  f"ATE = {result['ate_m']:.4f} m")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="pose-graph replay")
    ap.add_argument("-poses", required=True)
    ap.add_argument("-links", required=True)
    ap.add_argument("-out", default=None)
    ap.add_argument("-gt", default=None)
    ap.add_argument("-iters", type=int, default=20)
    ap.add_argument("-quiet", action="store_true")
    a = ap.parse_args(argv)
    run(a.poses, a.links, a.out, a.gt, a.iters, a.quiet)


if __name__ == "__main__":
    main()
