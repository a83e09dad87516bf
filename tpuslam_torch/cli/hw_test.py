"""Hardware self-test CLI (the R5 debug shell / App_9DofHwTest twin).

Counterpart of tpuslam/cli/hw_test.py.  The reference firmware exposes a
UART debug shell (src/StereoBM/src/main.c:264-300) with hardware
self-tests: the 9-DoF IMU test (App_9DofHwTest, main.c:679-750), the
FPGA test-pattern generators (Parameters.h:61-68), and the free-running
timer (fpga.c:643-674).  The equivalents here exercise the same
subsystems: the synthetic LSM9DS1 register chain, the pattern generators
feeding the per-frame device front end (kernels K1, K5, K2 and K3's blur
on the card), frame-timing measurement (frame_meas.v twin), and a device
round-trip timer.

    python -m tpuslam_torch.cli.hw_test 9dof
    python -m tpuslam_torch.cli.hw_test patterns [-device cpu]
    python -m tpuslam_torch.cli.hw_test timing [-device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

PATTERN_SIZE = (480, 640)


def test_9dof() -> int:
    from ..io.imu import hw_test_9dof
    found = hw_test_9dof()
    return 0 if any(found) else 1


def test_patterns(device="cuda", outputs: dict | None = None) -> int:
    """Feed each FPGA test pattern through the device front end on
    `device` (the card unless the caller asks for the CPU) and check the
    outputs are finite and shaped — the FPGA_TEST SW-start analog
    (main.cpp:172-177).  `outputs`, where given, receives each pattern's
    outputs as host arrays."""
    import numpy as np
    from ..io.patterns import (PATTERN_COLOR_BAR, PATTERN_FRAME_INCR,
                               PATTERN_GRID, PATTERN_HORIZ_INCR,
                               PATTERN_VERT_INCR, generate_pattern)
    from ..dist.mesh import frontend_one
    from ..config import StereoBMConfig

    cfg = StereoBMConfig()
    ok = True
    for pat in (PATTERN_HORIZ_INCR, PATTERN_VERT_INCR, PATTERN_FRAME_INCR,
                PATTERN_COLOR_BAR, PATTERN_GRID):
        img = generate_pattern(pat, *PATTERN_SIZE)
        outs = [o.cpu().numpy()
                for o in frontend_one(img, img, cfg, device=device)]
        if outputs is not None:
            outputs[pat] = outs
        shapes = [o.shape for o in outs]
        finite = all(np.isfinite(o.astype(np.float64)).all() for o in outs)
        print(f"pattern {pat}: outputs {shapes} finite={finite}")
        ok &= finite
    return 0 if ok else 1


def test_timing(n: int = 30, device="cuda") -> int:
    """Round-trip device timer on `device` (the card unless the caller
    asks for the CPU) + frame_meas on a synthetic 30 fps stream."""
    import torch
    from ..runtime.frame_meas import FrameMeas

    x = torch.zeros((256, 256), dtype=torch.float32, device=device)

    def f(a):
        out = (a + 1).sum()
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out

    f(x)
    t0 = time.perf_counter()
    f(x)
    rtt_ms = (time.perf_counter() - t0) * 1e3
    print(f"device round-trip: {rtt_ms:.3f} ms")

    fm = FrameMeas()
    fm.trigger()
    for i in range(n):
        fm.feed(stamp=i / 30.0, height=480, width=640)
    st = fm.stats()
    print(f"frame_meas: v_period={st['v_period'] * 1e3:.2f} ms "
          f"h_period={st['h_period'] * 1e6:.2f} us fps={st['fps']:.2f} "
          f"jitter={st['jitter'] * 1e3:.3f} ms")
    return 0 if abs(st["fps"] - 30.0) < 0.5 else 1


def main(argv=None) -> int:
    """Run one self-test; `-device` (the card by default) says where the
    patterns and timing tests run."""
    ap = argparse.ArgumentParser(description="hardware self-tests")
    ap.add_argument("test", choices=["9dof", "patterns", "timing"])
    ap.add_argument("-device", default="cuda")
    args = ap.parse_args(argv)
    if args.test == "9dof":
        return test_9dof()
    return {"patterns": test_patterns,
            "timing": test_timing}[args.test](device=args.device)


if __name__ == "__main__":
    sys.exit(main())
