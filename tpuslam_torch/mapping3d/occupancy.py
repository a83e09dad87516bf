"""Occupancy-grid mapping: dense disparity -> world voxels -> .bt file.

Counterpart of tpuslam/mapping3d/occupancy.py (buildOccupancyGridMap,
the reference's main.cpp:495-561): for every *full* map node (weight !=
-1), reproject its stored decimated x16 disparity map through the
optimized pose, range-gate, and mark the hit voxels occupied in a 0.1 m
OctoMap tree; write `slam.bt`.  The reprojection of a node's map runs in
torch on `device`; the voxel-set dedupe (np.unique on packed 48-bit keys)
and the octree serialization (octree_bt.py, copied) stay on the host.

Quirk replicated on purpose: the reference gates points with
`v.norm() <= rangeMax * rangeMax` (main.cpp:500-501,545) — it compares
the *norm* against the *squared* range, so with rangeMax = 5.0 the
effective radius is 25 m.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import transform as T
from ..geometry.camera import StereoCameraModel
from .octree_bt import coords_to_keys, pack_keys, unpack_keys, write_bt


def _project_disparity_grid(disp_dec: torch.Tensor, full_pose: torch.Tensor,
                            origin: torch.Tensor, cam: torch.Tensor,
                            range_gate: float, scale: int):
    """Decimated x16 int16 (h, w) disparity -> (h, w, 3) f32 world points
    (zero where masked) and the (h, w) validity mask.

    cam = [cx_l, cy_l, fx_l, c(=cx_r-cx_l), wx_n, wy_n] as in
    Stereo.cpp:157-182; full_pose = optimized_pose @ local_transform
    (3, 4); origin = sensor origin (optimized pose translation,
    main.cpp:520).  All f32 on disp_dec's device.
    """
    dev = disp_dec.device
    d = disp_dec.to(torch.float32) / 16.0
    h, w = disp_dec.shape
    u = (torch.arange(w, dtype=torch.float32, device=dev) * scale)[None, :]
    v = (torch.arange(h, dtype=torch.float32, device=dev) * scale)[:, None]
    cx_l, cy_l, fx_l, c, wx_n, wy_n = cam
    denom = d + c
    Wx = wx_n / denom
    Wy = wy_n / denom
    x = (u - cx_l) * Wx
    y = (v - cy_l) * Wy
    z = fx_l * Wx
    pts_opt = torch.stack([x, y, z], dim=-1)             # (h,w,3) optical
    pts_w = pts_opt @ full_pose[:3, :3].T + full_pose[:3, 3]
    dist = torch.linalg.vector_norm(pts_w - origin, dim=-1)
    finite = torch.isfinite(pts_w).all(dim=-1)
    mask = (d > 0.0) & finite & (dist <= range_gate)
    pts_w = torch.where(mask[..., None], pts_w, 0.0)
    return pts_w, mask


class OccupancyGrid:
    """Sparse occupied-voxel set with OctoMap .bt export.

    Covers the used OctoMap surface (OcTree(res), coordToKeyChecked,
    updateNode(key, true), writeBinary) — see octree_bt.py.
    """

    def __init__(self, resolution: float = 0.1):
        self.resolution = float(resolution)
        self._chunks: list[np.ndarray] = []
        self._packed = np.zeros((0,), np.uint64)

    def update_points(self, points: np.ndarray,
                      mask: np.ndarray | None = None) -> None:
        pts = np.asarray(points, np.float64).reshape(-1, 3)
        if mask is not None:
            pts = pts[np.asarray(mask).reshape(-1)]
        if len(pts) == 0:
            return
        keys = coords_to_keys(pts, self.resolution)
        self._chunks.append(np.unique(pack_keys(keys)))

    def _consolidate(self) -> np.ndarray:
        if self._chunks:
            allp = np.concatenate([self._packed] + self._chunks)
            self._packed = np.unique(allp)
            self._chunks = []
        return self._packed

    @property
    def occupied_keys(self) -> np.ndarray:
        return unpack_keys(self._consolidate())

    @property
    def num_occupied(self) -> int:
        return len(self._consolidate())

    def occupied_centers(self) -> np.ndarray:
        from .octree_bt import keys_to_coords
        return keys_to_coords(self.occupied_keys, self.resolution)

    def write_bt(self, path: str) -> int:
        return write_bt(path, self.occupied_keys, self.resolution)


def _cam_vector(camera: StereoCameraModel) -> np.ndarray:
    wx_n = camera.Tx_l / camera.fx_l - camera.Tx_r / camera.fx_r
    wy_n = camera.Tx_l / camera.fy_l - camera.Tx_r / camera.fy_r
    return np.array([camera.cx_l, camera.cy_l, camera.fx_l,
                     camera.cx_r - camera.cx_l, wx_n, wy_n], np.float32)


def insert_depth_frame(grid: OccupancyGrid, disp_dec: np.ndarray,
                       disp_scale: int, pose: np.ndarray,
                       camera: StereoCameraModel,
                       range_max: float = 5.0, device="cuda") -> None:
    """Insert one node's decimated disparity map into the grid, projected
    on `device` (the card unless the caller asks for the CPU)."""
    full_pose = T.compose(pose, camera.local_transform).astype(np.float32)
    origin = pose[:3, 3].astype(np.float32)

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    # reference quirk: norm gated against range^2 (main.cpp:500-501,545)
    gate = float(np.float32(range_max * range_max))
    pts, mask = _project_disparity_grid(
        dev(disp_dec), dev(full_pose[:3]), dev(origin),
        dev(_cam_vector(camera)), gate, int(disp_scale))
    grid.update_points(pts.cpu().numpy(), mask.cpu().numpy())


def build_occupancy_grid_map(mapper, optimized_poses: dict,
                             camera: StereoCameraModel,
                             out_path: str = "slam.bt",
                             resolution: float = 0.1,
                             range_max: float = 5.0,
                             device="cuda") -> OccupancyGrid:
    """Twin of buildOccupancyGridMap (main.cpp:495-561), projecting on
    `device` (the card unless the caller asks for the CPU)."""
    grid = OccupancyGrid(resolution)
    for node_id in sorted(optimized_poses):
        node = mapper.nodes.get(node_id)
        if node is None or node.weight == -1:
            continue
        frame = node.frame
        if getattr(frame, "disparity_dec", None) is None:
            continue
        insert_depth_frame(grid, np.asarray(frame.disparity_dec),
                           frame.disp_scale,
                           np.asarray(optimized_poses[node_id], np.float64),
                           camera, range_max, device)
    if out_path:
        grid.write_bt(out_path)
    return grid
