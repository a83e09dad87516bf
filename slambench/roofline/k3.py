"""K3, ORB descriptors (tpuslam_torch/csrc/orb.cu: one call queues the
blur and the tests, once a chunk).  The image in once (1 B a pixel),
keypoints in (8 B) and descriptors out (32 B); a separable 7x7 blur (28
operations a pixel) and 256 compares a keypoint.  The keypoints are the
window's mean count a frame."""

KERNELS = ("orb_blur_kernel", "orb_tests_kernel")
CALLS = ("orb_tests_kernel",)


def cost(shape: dict) -> tuple[float, float]:
    px = shape["frames"] * shape["height"] * shape["width"]
    nkp = shape["frames"] * shape["kpts_per_frame"]
    return px + 40 * nkp, 28 * px + 256 * nkp
