"""Multi-device scaling: for now the per-frame device front end that the
frame-parallel step shards over frames (`mesh.frontend_one`).

Counterpart of tpuslam/dist/; its mesh setup, sharded steps, multi-host
runner and partitioned map are still to be ported on torch.distributed.
"""

from .mesh import frontend_one  # noqa: F401
