"""Per-frame device front end, the unit that the frame-parallel step
shards over frames.

Counterpart of tpuslam/dist/mesh.py's `frontend_one` (the rest of that
module, the mesh and its sharded steps, is still to be ported).  tpuslam
computes the disparity with its StereoBM strip kernel (`stereo_bm_auto`,
Pallas on a TPU) and the corner response and the blur in XLA; the port
has kernels that compute exactly those functions, so a CUDA pair runs
K1 and K5 (StereoBM with its left-right check, then the speckle pass),
K2 (the response: the first output of its response-and-dilation launch,
bit-equal to gftt_response at block 3) and K3's blur launcher
(`orb_blur_cuda`, bit-equal to orb_blur), each through its dispatcher
in `kernels/`.  A CPU pair runs their plain versions.
"""

from __future__ import annotations

import torch

from ..config import StereoBMConfig
from ..kernels.gftt import gftt_response_auto
from ..kernels.orb import orb_blur_auto
from ..kernels.stereo_bm import stereo_bm


def frontend_one(left, right, cfg: StereoBMConfig = StereoBMConfig(),
                 device="cuda"):
    """Per-frame device front end of one (H, W) uint8 stereo pair (numpy
    or tensors), on `device` (the card unless the caller asks for the
    CPU): (disparity (H, W) int16 x16 with the speckle pass, GFTT
    response (H, W) float32 at block 3, the 7x7 blurred left image
    (H, W) uint8 for descriptors)."""
    lb = torch.as_tensor(left, device=device)[None].contiguous()
    rb = torch.as_tensor(right, device=device)[None].contiguous()
    disp = stereo_bm(lb, rb, cfg)                            # K1, K5
    eig = gftt_response_auto(lb, 3)                          # K2
    blurred = orb_blur_auto(lb)                              # K3's blur
    return disp[0], eig[0], blurred[0]
