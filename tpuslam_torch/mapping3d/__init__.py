"""3D occupancy mapping (OctoMap-equivalent used surface): counterpart of
tpuslam/mapping3d/.  The octree serialization is numpy, copied; the
reprojection of each node's disparity runs in torch on a device."""

from .occupancy import (OccupancyGrid, build_occupancy_grid_map,
                        insert_depth_frame)
from .octree_bt import (coords_to_keys, keys_to_coords, pack_keys,
                        read_bt, unpack_keys, write_bt)

__all__ = [
    "OccupancyGrid", "build_occupancy_grid_map", "insert_depth_frame",
    "coords_to_keys", "keys_to_coords", "pack_keys", "unpack_keys",
    "read_bt", "write_bt",
]
