"""Multi-process SLAM entry point: front-end-sharded VO over
torch.distributed with the rank-partitioned map back end.

Counterpart of tpuslam/cli/slam_multihost.py.  Launch one process per
rank; each extracts front-end features for its frame block on its device
(K1, K5, K2, K3 on the card), the features are all-gathered
(dist/multihost.py), every rank runs the deterministic VO (K6), and the
persistent map (BoW dictionary + keyframe features) is sharded by rank
(dist/partitioned_map.py) so per-rank map memory scales ~1/P with the
single-process decisions.

  python -m tpuslam_torch.cli.slam_multihost SEQ_DIR \
      -coord HOST:PORT -num-procs P -rank R [-replicated-map] \
      [-num-images N] [-out OUT_DIR] [-device cuda|cpu] \
      [-backend nccl|gloo] [-quiet]

`-num-procs 1` runs without a process group.  `-backend` defaults to
multihost.initialize's choice (NCCL when every rank has a card of its
own, gloo when ranks share a card or run on the CPU).  Each rank reads
only its block's images.  Writes OUT_DIR/poses_rank{R}.txt (the
optimized poses, a 3x4 row each) and OUT_DIR/result_rank{R}.json.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def run(seq_dir: str, coord: str | None = None, num_procs: int = 1,
        rank: int = 0, out_dir: str | None = None,
        partitioned: bool = True, num_images: int = -1,
        quiet: bool = False, device="cuda",
        backend: str | None = None) -> dict:
    """One rank's run on `device` (the card unless the caller asks for the
    CPU).  A process group this call initialises is destroyed before it
    returns."""
    import torch.distributed as dist
    from ..config import SlamConfig
    from ..geometry.camera import StereoCameraModel
    from ..io.dataset import StereoImageDataset
    from ..io.png import image_size
    from ..dist import multihost as mh
    from ..dist.partitioned_map import PartitionedMapper
    from ..mapping.mapper import Mapper
    from ..optim import run_optimize_robust
    from ..vo.odometry import Odometry

    chosen = mh.initialize(coord, num_procs, rank, backend, device)
    try:
        if num_procs > 1:
            if mh.process_count() != num_procs:
                raise RuntimeError(f"process group of "
                                   f"{mh.process_count()}, not {num_procs}")
            if not quiet:
                print(f"rank {rank}: backend {chosen}", flush=True)

        cfg = SlamConfig()
        left_dir = os.path.join(seq_dir, "image_0")
        ds = StereoImageDataset(
            left_dir=left_dir, right_dir=os.path.join(seq_dir, "image_1"),
            times_path=os.path.join(seq_dir, "times.txt"))
        camera = StereoCameraModel.load_kitti(
            os.path.join(seq_dir, "calib.txt"),
            image_size=image_size(os.path.join(left_dir, ds._left[0])))
        n = len(ds) if num_images < 0 else min(num_images, len(ds))
        stamps = np.array([ds.stamp(i) for i in range(n)])

        # front end: extract this rank's block, all-gather the features
        p = mh.process_count()
        blocks = [mh.frame_block(n, p, i) for i in range(p)]
        mine = blocks[mh.process_index()]
        items = [ds[i] for i in range(mine.start, mine.stop)]
        feats = mh.extract_block_features(
            np.stack([it["left"] for it in items]),
            np.stack([it["right"] for it in items]), camera, cfg,
            device=device)
        feats = mh.allgather_features(feats,
                                      [b.stop - b.start for b in blocks])

        # deterministic VO + rank-partitioned map over the gathered stream
        odom = Odometry(camera, cfg.odometry, cfg.matching, cfg.pnp,
                        device=device)
        if partitioned and p > 1:
            mapper = PartitionedMapper(camera, cfg.mapper, cfg.matching,
                                       cfg.pnp, device=device)
        else:
            mapper = Mapper(camera, cfg.mapper, cfg.matching, cfg.pnp,
                            device=device)
        for i, frame in enumerate(mh.frames_from_features(feats, stamps)):
            info = odom.process(frame)
            mapper.process(frame, info)
            if not quiet and i % 20 == 0:
                print(f"rank {rank}: frame {i}/{n}", flush=True)
    finally:
        if chosen is not None:
            dist.destroy_process_group()

    poses, links = mapper.get_graph()
    optimized, chi2 = run_optimize_robust(
        poses, links, cfg.optimizer.final_iterations, cfg.optimizer)
    chi2 = float(np.ravel(chi2)[-1]) if np.size(chi2) else 0.0

    result = dict(n_frames=n,
                  n_loop_closures=len(mapper.loop_closures),
                  chi2=chi2,
                  map_bytes=mapper.memory_used(), backend=chosen)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        ids = sorted(optimized)
        rows = np.stack([np.asarray(optimized[i], np.float64)[:3]
                         .reshape(-1) for i in ids])
        np.savetxt(os.path.join(out_dir, f"poses_rank{rank}.txt"), rows)
        with open(os.path.join(out_dir, f"result_rank{rank}.json"),
                  "w") as f:
            json.dump({k: v for k, v in result.items()
                       if k != "map_bytes"} |
                      {"map_bytes": {k: int(v) for k, v in
                                     result["map_bytes"].items()}}, f)
    result["poses"] = optimized
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="multi-process SLAM (front-end-sharded + "
                    "rank-partitioned map)")
    ap.add_argument("seq_dir")
    ap.add_argument("-coord", default=None,
                    help="rank 0's host:port (required for P > 1)")
    ap.add_argument("-num-procs", type=int, default=1)
    ap.add_argument("-rank", type=int, default=0)
    ap.add_argument("-out", default=None)
    ap.add_argument("-replicated-map", dest="partitioned",
                    action="store_false",
                    help="replicate the map on every rank instead of "
                         "sharding it")
    ap.add_argument("-num-images", type=int, default=-1)
    ap.add_argument("-quiet", action="store_true")
    ap.add_argument("-device", default="cuda",
                    help="torch device of the device work (default: the "
                         "card)")
    ap.add_argument("-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend (default: NCCL when "
                         "every rank has a card of its own, else gloo)")
    a = ap.parse_args(argv)
    run(a.seq_dir, coord=a.coord, num_procs=a.num_procs, rank=a.rank,
        out_dir=a.out, partitioned=a.partitioned,
        num_images=a.num_images, quiet=a.quiet, device=a.device,
        backend=a.backend)


if __name__ == "__main__":
    main()
