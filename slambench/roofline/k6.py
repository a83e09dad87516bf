"""K6, the LM refine with errors (tpuslam_torch/csrc/lm_refine.cu, one
launch a frame's refine round over the capacity's points; loop closure's
calls counted alike).  Per point obj, img, weight, valid in and the error
out (29 B); 21 evaluations of ~150 operations."""

KERNELS = ("lm_kernel",)
CALLS = ("lm_kernel",)


def cost(shape: dict) -> tuple[float, float]:
    n = shape["capacity"]
    return 29 * n, 21 * 150 * n
