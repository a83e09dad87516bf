"""Multi-device scaling on torch.distributed: the device mesh, the
frame-parallel front end, the sharded pose graph, BA and dictionary
steps, the frame-sharded multi-process VO and the rank-partitioned map.

Counterpart of tpuslam/dist/.  The device model keeps tpuslam's two
levels and their numerics:

  * inside one process, a `mesh.Mesh` of local shards, each on a torch
    device (`make_mesh(n, axis, device)`; on one card n shards share it,
    as the JAX suite's 8 virtual CPU devices share one CPU): tpuslam's
    `shard_map` over a mesh of local devices, the ICI level.  A sharded
    step computes each shard's partial on its device and sums the
    partials in shard order (tpuslam's `psum` inside a process);
  * across processes, the default torch.distributed process group
    (`multihost.initialize`): tpuslam's `jax.distributed`, the DCN
    level.  The partial of each process then meets the others in one
    `all_reduce` (SUM, or MAX for `pmax`), `broadcast` or `all_gather`,
    so the same step runs on a global mesh of world size x local shards,
    in (rank, local shard) order.  Without a process group every
    collective is the identity across processes
    (`jax.process_count() == 1`).

`multihost` shards the front end over processes by frame blocks and
gathers the compact feature arrays; every rank then runs the same
deterministic VO.  `partitioned_map` partitions the persistent map by
rank (word_id % P, node_id % P) with the single-process Mapper's exact
decisions.  torch.distributed.device_mesh / DTensor are not used: they
do not give the one-process virtual mesh that the CPU tests need.
"""

from .mesh import (frontend_one, make_mesh,  # noqa: F401
                   sharded_frontend_step, sharded_pose_graph_step)
