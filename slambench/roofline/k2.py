"""K2, the GFTT response and its 3x3 dilation (tpuslam_torch/csrc/gftt.cu,
one launch a chunk).  Per pixel the image in (1 B), response and dilation
out (8 B); ~40 operations (Sobel pair, three products, three 3x3 box
sums, the eigenvalue, the dilation)."""

KERNELS = ("gftt_kernel",)
CALLS = ("gftt_kernel",)


def cost(shape: dict) -> tuple[float, float]:
    px = shape["frames"] * shape["height"] * shape["width"]
    return 9 * px, 40 * px
