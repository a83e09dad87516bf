"""tpuslam_torch — the stereo visual SLAM engine in PyTorch, with CUDA
kernels written by hand for NVIDIA Hopper (sm_90a).

A port of `tpuslam` (JAX/Pallas) that mirrors its layout: the counterpart
of `tpuslam/<path>.py` is `tpuslam_torch/<path>.py`.  `tpuslam` stays the
reference the port is tested against; this package never imports it or
JAX, so it runs on a machine that has neither.

Layer map:
  config      — the reference constants (copy of tpuslam.config)
  geometry    — SE3 transforms, stereo camera model, KITTI metric (copies)
  io          — the synthetic box-world sequence, rendered in torch (in
                memory or written as a KITTI-layout directory; procedural
                or photo texture), the KITTI-layout dataset reader, a
                grayscale PNG codec, test patterns and the synthetic IMU
                (copies)
  kernels     — StereoBM and its LR check, GFTT, ORB, matching,
                EPnP-RANSAC and the LM refine; each hand-written CUDA
                kernel sits beside its plain PyTorch version
  vo          — the fused chunk VO (front end batched over the chunk, then
                the per-frame VO state machine), registration and the
                Odometry state machine of the per-frame path
  mapping     — the Mapper: dictionary, chunk dictionary, loop closure,
                pose-graph data, BA windows
  mapping3d   — the occupancy grid and its OctoMap .bt export
  optim       — the pose graph (host f64) and bundle adjustment
  runtime     — the chunk driver (FastSlamPipeline), the per-frame front
                end, the named-span profiler, the stage dumps and the
                frame-timing twin
  calib       — chessboard detection and stereo calibration (LM on the
                device), YAML output
  dist        — the multi-device layer on torch.distributed: the mesh
                and its sharded steps (front end, pose graph, BA,
                dictionary), the multi-process VO and the rank-partitioned
                map
  cli         — the batch, realtime and multi-process SLAM apps, the
                pose-graph replay and the tool apps (kernel_test, hw_test,
                stereo_calib, stereo_capture)
  csrc        — the CUDA C++ sources, built at first use by nvcc
"""

import torch as _torch

__version__ = "0.1.0"

# f32-exact matmuls and convolutions everywhere: the twin of tpuslam's
# jax_default_matmul_precision="highest" pin.  Reduced-precision products
# corrupt the fused VO's pose chain (PERF_TPU_HISTORY.md "Correctness
# note": bf16 took t_err from 0.20 % to 10.8 %); on Hopper the reduced
# format is TF32, which cuBLAS and cuDNN would otherwise be allowed to use.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
