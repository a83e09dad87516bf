"""The card's published peaks, against which every roofline share is
stated: NVIDIA's H100 SXM data sheet, HBM bytes/s and 32-bit operations/s
outside the tensor cores (132 SMs x 128 FP32 lanes x an FMA's two
operations x 1.98 GHz), at the full 700 W power limit.  Copied from
tpuslam_torch/tools/timing.py's `bound`."""

HBM_BPS = 3.35e12
OPS_32 = 67e12


def least_ms(nbytes: float, ops: float) -> float:
    """The least time in ms for moving `nbytes` and doing `ops` 32-bit
    operations at the peaks: the larger of the two."""
    return max(nbytes / HBM_BPS, ops / OPS_32) * 1e3
