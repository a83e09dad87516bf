"""K1, StereoBM (tpuslam_torch/csrc/stereo_bm.cu, one call a chunk: the
prefilter launch, then the packed kernel or, outside its configurations,
the wide one).  Per pixel the pair in (2 B) and int16 disparity and int32
min-SAD out (6 B); per pixel and disparity an absolute difference, two
running-sum updates a box direction and a compare (6 operations)
(PERF.md's K1 row)."""

KERNELS = ("prefilter_kernel", "bm_packed_kernel", "bm_wide_kernel",
           "bm_wide_global_kernel")
CALLS = ("bm_packed_kernel", "bm_wide_kernel", "bm_wide_global_kernel")


def cost(shape: dict) -> tuple[float, float]:
    px = shape["frames"] * shape["height"] * shape["width"]
    return 8 * px, 6 * shape["ndisp"] * px
