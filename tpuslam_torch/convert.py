"""Carry state across from the JAX package.

SLAM has no learned weights: its parameters are the configuration, the
camera, between chunks the VO carry, and the map: the visual-word
dictionary and the pose graph.  These helpers take tpuslam's objects
(duck-typed: this module never imports tpuslam or JAX) and build the
port's, so a test can start both implementations from one state.
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import numpy as np
import torch

from . import config as _config
from .geometry.camera import StereoCameraModel
from .mapping.dictionary import VisualWord, VWDictionary
from .mapping.graph import Link, MultiMap

# VO carry field -> torch dtype (see vo/fused.py init_carry)
CARRY_DTYPES = {
    "pose": torch.float32, "vel": torch.float32, "has_vel": torch.bool,
    "kf_pose": torch.float32, "ref_kpts": torch.float32,
    "ref_pts3d": torch.float32, "ref_bits": torch.float32,
    "ref_nbits": torch.float32, "ref_valid": torch.bool,
    "ref_n": torch.int64, "num_objects": torch.int64,
    "frames": torch.int64, "dist": torch.float32,
}


def _convert(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(_config, type(obj).__name__)
        return cls(**{f.name: _convert(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, Enum):
        return getattr(_config, type(obj).__name__)(obj.value)
    return obj


def config_from_reference(cfg) -> _config.SlamConfig:
    """tpuslam.config.SlamConfig -> tpuslam_torch.config.SlamConfig, field
    by field (nested dataclasses and enums matched by class name)."""
    return _convert(cfg)


def camera_from_reference(cam) -> StereoCameraModel:
    """tpuslam StereoCameraModel -> the port's (same P matrices, size)."""
    return StereoCameraModel(P_l=np.array(cam.P_l, np.float64),
                             P_r=np.array(cam.P_r, np.float64),
                             width=int(cam.width), height=int(cam.height))


def carry_from_reference(carry_np: dict, device="cuda") -> dict:
    """JAX fused-VO carry, as a dict of numpy arrays -> the port's carry
    of tensors on `device`."""
    missing = set(CARRY_DTYPES) - set(carry_np)
    if missing:
        raise KeyError(f"carry lacks {sorted(missing)}")
    return {k: torch.as_tensor(np.array(carry_np[k])).to(
        device=device, dtype=dt) for k, dt in CARRY_DTYPES.items()}


def _copy_words(vwd, out):
    """Train rows, row word ids, count, capacity, last word id and every
    word with its references, from tpuslam's dictionary `vwd` into `out`."""
    out._capacity = int(vwd._capacity)
    out._train = np.array(vwd._train, np.float32)
    out._word_ids = np.array(vwd._word_ids, np.int64)
    out._count = int(vwd._count)
    out._last_word_id = int(vwd._last_word_id)
    for wid, w in vwd.words.items():
        vw = VisualWord(int(w.id), np.array(w.descriptor), 0)
        vw.references = {int(k): int(v) for k, v in w.references.items()}
        vw.total_references = int(w.total_references)
        out.words[int(wid)] = vw
    return out


def dictionary_from_reference(vwd, device="cuda") -> VWDictionary:
    """tpuslam VWDictionary -> the port's: train rows, row word ids, count,
    last word id and every word with its references."""
    return _copy_words(vwd, VWDictionary(vwd.nndr, device))


def sharded_dictionary_from_reference(vwd, device="cuda", comm=None):
    """One rank's tpuslam ShardedVWDictionary -> the port's: its owned
    rows, their word ids and words with their references, and the global
    counters (last word id, total words), for the same rank and world;
    `comm` is the port's all-gather (None: the default)."""
    from .dist.partitioned_map import ShardedVWDictionary
    out = ShardedVWDictionary(vwd.nndr, int(vwd.rank), int(vwd.world),
                              comm=comm, device=device)
    out._total_words = int(vwd._total_words)
    return _copy_words(vwd, out)


def graph_from_reference(poses: dict, links) -> tuple[dict, MultiMap]:
    """A tpuslam pose graph (Mapper.get_graph(): node id -> 4x4 pose, and
    its MultiMap of Links) -> the port's, as numpy."""
    out = MultiMap()
    for key, link in links.items():
        out.insert(int(key), Link(int(link.from_id), int(link.to_id),
                                  int(link.type), np.array(link.transform),
                                  np.array(link.info, np.float64)))
    return {int(k): np.array(v) for k, v in poses.items()}, out
