"""Kernel A/B test harness (FPGA_TEST app-mode twin).

Counterpart of tpuslam/cli/kernel_test.py.  The reference's FPGA_TEST
mode (src/slam/src/core/main.cpp:165-181, Parameters.h:21) injects the
*same files* into the hardware pipeline that SLAM_BATCH feeds through
OpenCV, so the two implementations can be diffed stage by stage.  Here
the two sides are:

  A) the hardware-semantics stages (fixed-point rectifier + HW bilinear
     warp, 6-bit xsobel, int16 x16 SAD disparity: kernels K1 and K5 on
     the card)
  B) float/CPU-twin oracles of the same stages

Each stage's outputs are diffed and dumped (SensorData dump twins), and
the shipped golden PL data is checked when the input is the golden rect
pair.  Exit status is nonzero on any tolerance breach.  The speckle pass
labels to its fixpoint (cv2.filterSpeckles), where tpuslam's stops after
16 rounds, so the disparity entry of the report may differ from
tpuslam's on real images.

    python -m tpuslam_torch.cli.kernel_test [-l L -r R] [-out DIR]
        [-device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

FIXTURES = os.path.join(os.path.dirname(__file__), "..", "..", "tests",
                        "fixtures")


def run(left_path: str | None = None, right_path: str | None = None,
        out_dir: str = "kernel_test_out", quiet: bool = False,
        device="cuda", arrays: dict | None = None) -> dict:
    """The A/B report on a stereo pair (.npy or image files; the golden
    fixture pair by default), computed on `device` (the card unless the
    caller asks for the CPU); the dumps go to `out_dir`.  `arrays`, where
    given, receives each stage's output as a host array: "rect_hw",
    "rect_float", "xsobel_hw", "xsobel", "disparity", "eig"."""
    from ..config import StereoBMConfig
    from ..io.dataset import load_gray
    from ..kernels.gftt import gftt_response_auto
    from ..kernels.rectify import (StereoRectifier, remap_bilinear,
                                   rect_map_fixed, REFERENCE_CALIB)
    from ..kernels.stereo_bm import (prefilter_xsobel, prefilter_xsobel_hw,
                                     stereo_bm)
    from ..runtime.dumps import (save_depth_image, save_eigenvalue,
                                 save_rect_image_pair)

    if left_path is None:
        left_path = os.path.join(FIXTURES, "rect_left.npy")
        right_path = os.path.join(FIXTURES, "rect_right.npy")

    def load(p):
        return np.load(p) if p.endswith(".npy") else load_gray(p)

    left = torch.as_tensor(load(left_path), device=device)
    right = torch.as_tensor(load(right_path), device=device)
    os.makedirs(out_dir, exist_ok=True)
    report: dict[str, dict] = {}

    # --- rectifier: fixed-point vs float path on the raw stimulus ------
    raw_l = np.load(os.path.join(FIXTURES, "raw_left.npy"))
    rect_hw = StereoRectifier.from_reference_calib(device=device)
    out_hw, _ = rect_hw(raw_l, raw_l)
    mx, my = rect_map_fixed(REFERENCE_CALIB[0], 480, 640)
    out_fl = remap_bilinear(
        torch.as_tensor(raw_l, device=device),
        torch.as_tensor(mx / 32.0, dtype=torch.float32, device=device),
        torch.as_tensor(my / 32.0, dtype=torch.float32, device=device))
    out_hw, out_fl = out_hw.cpu().numpy(), out_fl.cpu().numpy()
    m = out_hw > 0
    diff = np.abs(out_hw.astype(float) - out_fl)[m]
    report["rectify_hw_vs_float"] = {
        "max_abs": float(diff.max()), "mean_abs": float(diff.mean()),
        "pass": bool(diff.max() <= 1.5)}
    save_rect_image_pair(out_dir, 0, out_hw, out_fl)

    # --- xsobel: HW 6-bit vs CPU-twin (cap 31) + golden check ----------
    hw = prefilter_xsobel_hw(left).cpu().numpy()
    cpu = prefilter_xsobel(left).cpu().numpy()
    # centers differ (32 vs 31); compare recentered interiors
    d = np.abs(hw[1:-1, 1:-1].astype(int) - 32
               - (cpu[1:-1, 1:-1].astype(int) - 31))
    report["xsobel_hw_vs_cpu"] = {
        "max_abs": float(d.max()),
        "pass": bool((d <= 1).mean() > 0.999)}
    gold_p = os.path.join(FIXTURES, "xsbl_left.npy")
    if os.path.exists(gold_p) and left_path.endswith("rect_left.npy"):
        gold = np.load(gold_p)
        report["xsobel_vs_golden"] = {
            "mismatches": int((hw != gold).sum()),
            "pass": bool(np.array_equal(hw, gold))}

    # --- disparity + gftt dumps on the input pair ----------------------
    disp = stereo_bm(left[None], right[None], StereoBMConfig())[0]  # K1, K5
    eig = gftt_response_auto(left[None], 3)[0]                      # K2
    disp, eig = disp.cpu().numpy(), eig.cpu().numpy()
    if arrays is not None:
        arrays.update(rect_hw=out_hw, rect_float=out_fl, xsobel_hw=hw,
                      xsobel=cpu, disparity=disp, eig=eig)
    save_depth_image(out_dir, 0, disp)
    save_eigenvalue(out_dir, 0, eig)
    valid = disp > 0
    report["disparity"] = {
        "valid_frac": float(valid.mean()),
        "mean_disp": float((disp[valid] / 16.0).mean()) if valid.any()
        else 0.0,
        "pass": bool(valid.mean() > 0.1)}

    ok = all(v.get("pass", True) for v in report.values())
    report["all_pass"] = ok
    if not quiet:
        for k, v in report.items():
            print(k, v)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description="kernel A/B test harness")
    ap.add_argument("-l", dest="left", default=None)
    ap.add_argument("-r", dest="right", default=None)
    ap.add_argument("-out", default="kernel_test_out")
    ap.add_argument("-quiet", action="store_true")
    ap.add_argument("-device", default="cuda")
    a = ap.parse_args(argv)
    report = run(a.left, a.right, a.out, a.quiet, device=a.device)
    raise SystemExit(0 if report["all_pass"] else 1)


if __name__ == "__main__":
    main()
