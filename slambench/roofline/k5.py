"""K5, the left-right check (tpuslam_torch/csrc/lr_check.cu, one launch a
chunk).  Per pixel int16 disparity and int32 min-SAD in and int16
disparity out (8 B); ~20 integer operations for the projection and the
two checks."""

KERNELS = ("lr_kernel",)
CALLS = ("lr_kernel",)


def cost(shape: dict) -> tuple[float, float]:
    px = shape["frames"] * shape["height"] * shape["width"]
    return 8 * px, 20 * px
