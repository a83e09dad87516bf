"""Stereo calibration CLI (src/stereo_calib tool twin).

Counterpart of tpuslam/cli/stereo_calib.py.  Reads stereo chessboard captures (dir/left_*.png + right_*.png, or
image_0/ + image_1/ subdirs), detects the board, runs stereo
calibration + rectification, and writes intrinsics.yml /
extrinsics.yml (stereo_calib.cpp:303-316) plus per-camera
left_camera.yml / right_camera.yml consumable by the SLAM pipeline's
StereoCameraModel loader.  Images are read by io/dataset.py's
`load_gray` (equal to Pillow's `convert("L")`); the saddle response and
the calibration's LM refinement run on the card unless the caller asks
for the CPU (`-device cpu`).

    python -m tpuslam_torch.cli.stereo_calib -dir DIR [-nx 9 -ny 6
        -square 0.025] [-out OUT] [-device cpu]
"""

from __future__ import annotations

import argparse
import os


def _pairs(d: str):
    if os.path.isdir(os.path.join(d, "image_0")):
        l_dir, r_dir = os.path.join(d, "image_0"), os.path.join(d, "image_1")
        names = sorted(os.listdir(l_dir))
        return ([os.path.join(l_dir, n) for n in names],
                [os.path.join(r_dir, n) for n in names])
    names = sorted(os.listdir(d))
    lefts = [os.path.join(d, n) for n in names if n.startswith("left")]
    rights = [os.path.join(d, n) for n in names if n.startswith("right")]
    return lefts, rights


def run(image_dir: str, nx: int = 9, ny: int = 6, square: float = 0.025,
        out_dir: str | None = None, quiet: bool = False,
        device="cuda") -> dict:
    """Calibrate the rig of `image_dir`'s chessboard pairs on `device`
    (the card unless the caller asks for the CPU) and write the four YAML
    files to `out_dir` (default `image_dir`); returns the calibration."""
    from ..io.dataset import load_gray
    from ..calib import (find_chessboard, q_matrix, stereo_calibrate,
                         stereo_rectify, write_camera_info_yaml,
                         write_opencv_yaml)

    out_dir = out_dir or image_dir
    lefts, rights = _pairs(image_dir)
    corners_l, corners_r = [], []
    size = None
    for lp, rp in zip(lefts, rights):
        il = load_gray(lp)
        ir = load_gray(rp)
        size = (il.shape[1], il.shape[0])
        cl, okl = find_chessboard(il, nx, ny, device=device)
        cr, okr = find_chessboard(ir, nx, ny, device=device)
        if okl and okr:
            corners_l.append(cl)
            corners_r.append(cr)
        elif not quiet:
            print(f"board not found in {os.path.basename(lp)} "
                  f"(L {okl} / R {okr})")
    if len(corners_l) < 3:
        raise RuntimeError(
            f"only {len(corners_l)} usable views; need >= 3")

    calib = stereo_calibrate(corners_l, corners_r, nx, ny, square, size,
                             device=device)
    R1, R2, P1, P2 = stereo_rectify(calib["K1"], calib["D1"], calib["K2"],
                                    calib["D2"], size, calib["R"],
                                    calib["T"])
    Q = q_matrix(P1, P2)

    write_opencv_yaml(os.path.join(out_dir, "intrinsics.yml"),
                      {"M1": calib["K1"], "D1": calib["D1"],
                       "M2": calib["K2"], "D2": calib["D2"]})
    write_opencv_yaml(os.path.join(out_dir, "extrinsics.yml"),
                      {"R": calib["R"], "T": calib["T"], "R1": R1,
                       "R2": R2, "P1": P1, "P2": P2, "Q": Q})
    write_camera_info_yaml(os.path.join(out_dir, "left_camera.yml"),
                           size[0], size[1], P1, R1, calib["K1"],
                           calib["D1"], "left")
    write_camera_info_yaml(os.path.join(out_dir, "right_camera.yml"),
                           size[0], size[1], P2, R2, calib["K2"],
                           calib["D2"], "right")
    if not quiet:
        b = -P2[0, 3] / P2[0, 0]
        print(f"{len(corners_l)} views, rms {calib['rms']:.4f} px, "
              f"baseline {b * 100:.2f} cm -> intrinsics.yml / "
              f"extrinsics.yml")
    calib.update(R1=R1, R2=R2, P1=P1, P2=P2, Q=Q,
                 n_views=len(corners_l))
    return calib


def main(argv=None):
    ap = argparse.ArgumentParser(description="stereo calibration")
    ap.add_argument("-dir", required=True)
    ap.add_argument("-nx", type=int, default=9)
    ap.add_argument("-ny", type=int, default=6)
    ap.add_argument("-square", type=float, default=0.025)
    ap.add_argument("-out", default=None)
    ap.add_argument("-quiet", action="store_true")
    ap.add_argument("-device", default="cuda")
    a = ap.parse_args(argv)
    run(a.dir, a.nx, a.ny, a.square, a.out, a.quiet, device=a.device)


if __name__ == "__main__":
    main()
