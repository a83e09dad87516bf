"""K4, the covariance medians (tpuslam_torch/csrc/median.cu, one launch a
frame over the capacity's rows).  Two f32 rows and the mask in (9 B an
entry), ~8 operations an entry for the two selections."""

KERNELS = ("median2_kernel",)
CALLS = ("median2_kernel",)


def cost(shape: dict) -> tuple[float, float]:
    n = shape["capacity"]
    return 9 * n, 8 * n
