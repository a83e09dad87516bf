"""Dataset capture app (STEREO_CAPTURE / FRAME_GRABBER twins).

Counterpart of tpuslam/cli/stereo_capture.py.  The reference's
appStereoCapture (src/slam/src/core/main.cpp:390-475) records the live
sensor stream to a KITTI-layout dataset (capture/<ts>/image_0, image_1,
timestamp.txt); appFrameGrabber (main.cpp:477-493) records raw frames
only.  Without MIPI cameras, sources here are the synthetic world
renderer (io/synthetic.py's write_sequence, rendered on the device) or
the FPGA-style test patterns (fault injection, Parameters.h:61-68); with
`-frontend` each captured pair also runs the per-frame front end
(runtime/pipeline.py's extract_features: kernels K1, K5, K2 and K3 on the
card) and the GFTT response for the eigenvalue dump (K2 again), and
writes the per-stage debug dumps (SensorData.cpp:135-263 twins).

    python -m tpuslam_torch.cli.stereo_capture [-out DIR] [-n N]
        [-source synthetic|pattern] [-pattern P] [-frontend]
        [-device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..io.patterns import generate_pattern


def run(out_dir: str, n_frames: int = 20, source: str = "synthetic",
        pattern: int = 5, frontend: bool = False, seed: int = 0,
        quiet: bool = False, device="cuda") -> str:
    """Capture `n_frames` stereo pairs into a KITTI-layout directory,
    rendering and running the front end on `device` (the card unless the
    caller asks for the CPU).

    source: "synthetic" (rendered moving world) or "pattern" (test
    patterns, FRAME_GRABBER-style raw capture).
    Returns the dataset directory.
    """
    from ..io.png import write_png
    stamp_dir = os.path.join(out_dir, f"{int(time.time()) % 1000000:06d}")
    left_dir = os.path.join(stamp_dir, "image_0")
    right_dir = os.path.join(stamp_dir, "image_1")
    os.makedirs(left_dir, exist_ok=True)
    os.makedirs(right_dir, exist_ok=True)

    if source == "synthetic":
        from ..io.synthetic import write_sequence
        write_sequence(stamp_dir, n_frames=n_frames, seed=seed,
                       device=device)
    else:
        with open(os.path.join(stamp_dir, "timestamp.txt"), "w") as ft:
            for i in range(n_frames):
                img = generate_pattern(pattern, frame_index=i)
                write_png(os.path.join(left_dir, f"{i:06d}.png"), img)
                write_png(os.path.join(right_dir, f"{i:06d}.png"), img)
                ft.write(f"{i / 30.0:.6f}\n")  # 30 fps sensor rate

    if frontend:
        from ..config import SlamConfig
        from ..geometry.camera import StereoCameraModel
        from ..io.dataset import load_gray
        from ..kernels.gftt import gftt_response_auto
        from ..runtime.dumps import dump_frame
        from ..runtime.pipeline import extract_features

        cfg = SlamConfig()
        calib = os.path.join(stamp_dir, "calib.txt")
        if os.path.exists(calib):
            camera = StereoCameraModel.load_kitti(calib,
                                                  image_size=(640, 480))
        else:
            camera = _default_camera()
        dump_dir = os.path.join(stamp_dir, "dumps")
        names = sorted(os.listdir(left_dir))
        for i, name in enumerate(names):
            left = load_gray(os.path.join(left_dir, name))
            right = load_gray(os.path.join(right_dir, name))
            frame = extract_features(left, right, camera, cfg,
                                     stamp=i / 30.0, frame_id=i,
                                     device=device)
            eig = gftt_response_auto(
                torch.as_tensor(left, device=device)[None],
                cfg.gftt.block_size)[0].cpu().numpy()
            dump_frame(dump_dir, i, frame, eig)
            if not quiet:
                print(f"captured {name}: {frame.n_kpts} kpts")
    return stamp_dir


def _default_camera():
    from ..geometry.camera import StereoCameraModel
    f, cx, cy, B = 500.0, 320.0, 240.0, 0.06
    P0 = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -f * B
    return StereoCameraModel(P_l=P0, P_r=P1, width=640, height=480)


def main(argv=None):
    ap = argparse.ArgumentParser(description="stereo capture app")
    ap.add_argument("-out", default="capture")
    ap.add_argument("-n", dest="n_frames", type=int, default=20)
    ap.add_argument("-source", choices=["synthetic", "pattern"],
                    default="synthetic")
    ap.add_argument("-pattern", type=int, default=5)
    ap.add_argument("-frontend", action="store_true")
    ap.add_argument("-quiet", action="store_true")
    ap.add_argument("-device", default="cuda")
    a = ap.parse_args(argv)
    path = run(a.out, a.n_frames, a.source, a.pattern, a.frontend,
               quiet=a.quiet, device=a.device)
    print(path)


if __name__ == "__main__":
    main()
