"""Yardsticks of the depth engines for chip_smoke.py's ATE bounds: tpuslam
(JAX, on the CPU) on the frames the port's SGBM main path and realtime
app run on the card, with quality metrics only.

    JAX_PLATFORMS=cpu python yardstick_depth.py main [--chunk 2]
    JAX_PLATFORMS=cpu python yardstick_depth.py realtime-sgbm|realtime-lk \
        [--workdir DIR]
    JAX_PLATFORMS=cpu python yardstick_depth.py real-texture \
        [--workdir DIR]

`main`: FastSlamPipeline.run_staged over the bench's 120 frames
(chip_smoke.py's sequence, rendered by the port on the CPU) in
SlamConfig(depth_method="sgbm") with a Mapper (async loop closure), as
chip_smoke.py's SGBM main path; a small chunk bounds host memory (~15 GB
at chunk 2; the trajectory does not depend on it).  `realtime-*`:
tpuslam.cli.slam_realtime.run over chip_smoke.py's per-frame sequence
(61 frames out and back, written by the port on the CPU into --workdir)
with the small-memory Mapper and the named depth method.  `real-texture`:
tests/test_real_texture.py's pipeline (tpuslam's make_sequence with the
fixture's real frame as texture, written into --workdir and read back,
run_staged at chunk 20), the yardstick of chip_smoke.py's phase 15 (e),
which renders the same world on the card (~75 s); its `drift` says where
the error grows, as chip_smoke.py logs it for the card's runs.  Prints one JSON
line (no timing: a CPU run says nothing about the card).  It imports both
packages, so it runs where JAX does, not on the card's machine.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

import chip_smoke as C


def main_path(chunk: int) -> dict:
    from tpuslam.config import DepthMethod, SlamConfig
    from tpuslam.geometry.camera import StereoCameraModel
    from tpuslam.geometry.kitti_metric import calc_kitti_sequence_errors
    from tpuslam.mapping.mapper import Mapper
    from tpuslam.runtime.fast_pipeline import FastSlamPipeline
    from tpuslam_torch.io.synthetic import make_sequence, sequence_camera
    lefts, rights, stamps, gt = make_sequence(
        C.N_FRAMES, C.WIDTH, C.HEIGHT, C.FOCAL, C.BASELINE, C.SPEED, C.YAW,
        C.SEED, device="cpu")
    lefts, rights, gt = lefts.numpy(), rights.numpy(), np.asarray(gt)
    pc = sequence_camera(C.WIDTH, C.HEIGHT, C.FOCAL, C.BASELINE)
    camera = StereoCameraModel(P_l=pc.P_l, P_r=pc.P_r, width=C.WIDTH,
                               height=C.HEIGHT)
    cfg = SlamConfig(depth_method=DepthMethod.SGBM)
    items = [dict(left=lefts[i], right=rights[i], stamp=float(stamps[i]),
                  ground_truth=gt[i]) for i in range(C.N_FRAMES)]
    pipe = FastSlamPipeline(camera, cfg, chunk=chunk, capacity=C.CAPACITY)
    mapper = Mapper(camera, cfg.mapper, cfg.matching, cfg.pnp)
    mapper.async_lc = True
    infos = pipe.run_staged(pipe.stage_chunks(items), items, mapper=mapper,
                            mapper_async=True)
    est = np.stack([i.pose for i in infos])
    inl = sorted(i.num_inliers for i in infos[1:])
    t_err, r_err = calc_kitti_sequence_errors(gt, est)
    return dict(config="SGBM main path", chunk=chunk,
                lost=sum(1 for i in infos[1:] if i.lost),
                median_inliers=inl[len(inl) // 2], min_inliers=inl[0],
                ate_m=float(np.sqrt(np.mean(np.sum(
                    (est[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=1)))),
                t_err_pct=t_err, r_err_deg_per_m=r_err,
                nodes=len(mapper.nodes),
                loop_closures=len(mapper.loop_closures))


def realtime(method: str, workdir: str) -> dict:
    from tpuslam.cli import slam_realtime
    from tpuslam.config import DepthMethod, MapperConfig, SlamConfig
    from tpuslam.vo import odometry as O
    from tpuslam_torch.io.synthetic import out_and_back_trajectory, \
        write_sequence
    seq = os.path.join(workdir, "seq")
    write_sequence(seq, width=C.WIDTH, height=C.HEIGHT, f=C.FOCAL,
                   baseline=C.BASELINE,
                   poses=out_and_back_trajectory(C.PF_FORWARD, C.PF_SPEED),
                   seed=C.PF_SEED, device="cpu")
    process, lost = O.Odometry.process, []

    def recorded(self, frame):
        info = process(self, frame)
        lost.append(info.lost)
        return info
    O.Odometry.process = recorded
    cfg = SlamConfig(depth_method=DepthMethod(method)).replace(
        mapper=MapperConfig(map_update=C.PF_MAP_UPDATE,
                            max_stm_size=C.PF_MAX_STM))
    try:
        res = slam_realtime.run(seq, cfg, quiet=True,
                                out_dir=os.path.join(workdir, "out"))
    finally:
        O.Odometry.process = process
    return dict(config=f"realtime {method}", frames=res["n_frames"],
                lost=sum(lost[1:]), loop_closures=res["n_loop_closures"],
                ate_m=res["ate_m"])


def real_texture(workdir: str) -> dict:
    from tpuslam.config import SlamConfig
    from tpuslam.geometry.camera import StereoCameraModel
    from tpuslam.geometry.kitti_metric import calc_kitti_sequence_errors
    from tpuslam.io.dataset import StereoImageDataset
    from tpuslam.io.synthetic import make_sequence
    from tpuslam.runtime.fast_pipeline import FastSlamPipeline
    photo = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "fixtures", "rect_left.npy"))
    make_sequence(workdir, n_frames=C.RT_FRAMES, width=C.RT_W,
                  height=C.RT_H, f=C.RT_F, baseline=C.BASELINE,
                  speed=C.RT_SPEED, yaw_rate=C.RT_YAW, seed=C.RT_SEED,
                  texture_photo=photo)
    ds = StereoImageDataset(os.path.join(workdir, "image_0"),
                            os.path.join(workdir, "image_1"),
                            os.path.join(workdir, "times.txt"),
                            os.path.join(workdir, "poses.txt"))
    items = [ds[i] for i in range(len(ds))]
    camera = StereoCameraModel.load_kitti(
        os.path.join(workdir, "calib.txt"), image_size=(C.RT_W, C.RT_H))
    pipe = FastSlamPipeline(camera, SlamConfig(), chunk=C.RT_CHUNK,
                            capacity=C.CAPACITY)
    infos = pipe.run_staged(pipe.stage_chunks(items), items)
    gt = np.stack([it["ground_truth"] for it in items])
    est = np.stack([i.pose for i in infos])
    t_err, r_err = calc_kitti_sequence_errors(gt, est)
    return dict(config="real texture", frames=len(infos),
                lost=sum(1 for i in infos[1:] if i.lost),
                ate_m=float(np.sqrt(np.mean(np.sum(
                    (est[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=1)))),
                t_err_pct=t_err, r_err_deg_per_m=r_err,
                drift=C.drift_profile(infos, gt))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["main", "realtime-sgbm", "realtime-lk",
                                     "real-texture"])
    ap.add_argument("--chunk", type=int, default=2)
    ap.add_argument("--workdir", default=None)
    a = ap.parse_args(argv)
    if a.what == "main":
        out = main_path(a.chunk)
    elif a.what == "real-texture":
        with tempfile.TemporaryDirectory(dir=a.workdir) as wd:
            out = real_texture(wd)
    else:
        with tempfile.TemporaryDirectory(dir=a.workdir) as wd:
            out = realtime(a.what.split("-")[1], wd)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
