"""Multi-process scaling: the front end sharded over processes by frame
blocks, on torch.distributed.

Counterpart of tpuslam/dist/multihost.py (the reference's cross-domain
fabric mapped to collectives between hosts).  The split follows the
reference's asymmetry: the per-frame front end (disparity, corners,
descriptors, 3D lift) is parallel over frames and dominates the work,
while the back end (VO state machine, mapper, pose graph) is sequential
and cheap.  So:

  * every process extracts features for a contiguous block of frames on
    its device (`extract_block_features`, the fused VO's batched front
    end: K1, K5, K2 and K3 on a CUDA tensor),
  * only the compact per-frame feature arrays cross processes
    (`allgather_features`: ~1.5k keypoints x (3 + 3 + 32) values per
    frame, not images),
  * every process then runs the identical deterministic back end on the
    gathered stream (`vo_from_features`, K6 on the card), so any rank's
    trajectory is THE trajectory.

A 2-process run therefore gives the trajectory of a 1-process run, and
the sharded steps of dist/mesh.py run unchanged on a global mesh (their
collectives then cross processes).
"""

from __future__ import annotations

import logging
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..config import SlamConfig
from ..geometry.camera import StereoCameraModel
from ..vo.frame import Frame
from ..vo.fused import FusedShapes, make_frontend_fn
from ..vo.odometry import Odometry
from .mesh import COLLECTIVES

log = logging.getLogger(__name__)


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def host_layout(hosts: list[str], rank: int) -> tuple[int, int]:
    """(ranks on `rank`'s host, `rank`'s index among them), from every
    rank's host name in rank order."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return len(mine), mine.index(rank)


def choose_backend(ranks_on_host: int, device="cuda") -> str:
    """"nccl" when every rank can have a card of its own (this host shows
    at least as many cards as it runs ranks: one rank per host with a
    card qualifies), "gloo" when ranks would share a card or run on the
    CPU."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= ranks_on_host:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda") -> str | None:
    """torch.distributed bootstrap (a no-op, returning None, when
    single-process): every rank calls it with rank 0's "host:port".

    The ranks first meet in a TCP store at that address (rank 0 serves
    it) and post their host names, so each rank knows how many ranks
    share its host and its index among them (`host_layout`).  `backend`
    None chooses one from that count (`choose_backend` for `device`, the
    card unless the caller asks for the CPU); the choice is logged and
    returned.  On the card each rank takes its host's card (local index)
    mod (cards on the host), under either backend, so ranks spread over
    the host's cards.  The process group is then initialised over the
    same store.  A failed init raises: no other backend is tried."""
    if num_processes is None or num_processes <= 1:
        return None
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0)
    store.set(f"host/{process_id}", socket.gethostname())
    on_host, local = host_layout(
        [store.get(f"host/{r}").decode() for r in range(num_processes)],
        process_id)
    backend = backend or choose_backend(on_host, device)
    log.info("initialize: rank %d of %d (%d of %d on its host), backend "
             "%s", process_id, num_processes, local, on_host, backend)
    if torch.device(device).type == "cuda":
        if torch.cuda.device_count() == 0:
            raise RuntimeError("initialize: no CUDA device")
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)
    return backend


def process_allgather(arr: np.ndarray) -> np.ndarray:
    """(P, *arr.shape): `arr` of every process in rank order, through
    dist.all_gather (CPU tensors, or tensors on this rank's card for
    NCCL, which carries nothing else); a leading dimension of 1 in one
    process.  The bytes cross unchanged, float64 included."""
    if process_count() == 1:
        return np.asarray(arr)[None]
    on = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(on)
    outs = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(outs, t)
    COLLECTIVES["all_gather"] += 1
    return torch.stack(outs).cpu().numpy()


def frame_block(n_frames: int, num_processes: int | None = None,
                process_id: int | None = None) -> slice:
    """Contiguous frame range owned by this process (balanced split;
    the first `n_frames % P` blocks take one extra frame)."""
    p = process_count() if num_processes is None else num_processes
    i = process_index() if process_id is None else process_id
    base, rem = divmod(n_frames, p)
    lo = i * base + min(i, rem)
    return slice(lo, lo + base + (1 if i < rem else 0))


FEATURES = ("kpts", "pts3d", "desc", "n_kpts")


def extract_block_features(lefts: np.ndarray, rights: np.ndarray,
                           camera: StereoCameraModel, cfg: SlamConfig,
                           shapes: FusedShapes = FusedShapes(),
                           device="cuda") -> dict:
    """Run the device front end over a local frame block on `device` (the
    card unless the caller asks for the CPU), in batches of
    `shapes.chunk` frames (the last one shorter: a frame's features do
    not depend on its batch).

    Returns a dict of numpy arrays with leading dim = len(lefts):
    kpts (B,C,3) f32, pts3d (B,C,3) f32, desc (B,C,32) u8, n_kpts (B,)
    int32 (tpuslam's dtypes)."""
    frontend = make_frontend_fn(camera, cfg, shapes, device=device)
    out = {k: [] for k in FEATURES}
    for lo in range(0, len(lefts), shapes.chunk):
        lb = torch.as_tensor(lefts[lo:lo + shapes.chunk],
                             device=device).contiguous()
        rb = torch.as_tensor(rights[lo:lo + shapes.chunk],
                             device=device).contiguous()
        f = frontend(lb, rb)
        for k in FEATURES:
            out[k].append(f[k].cpu().numpy())
    out = {k: np.concatenate(v) for k, v in out.items()}
    out["n_kpts"] = out["n_kpts"].astype(np.int32)
    return out


def allgather_features(feats: dict, block_sizes: list[int]) -> dict:
    """Concatenate per-process feature blocks across processes (frame
    order).  `block_sizes[i]` is process i's frame count; blocks are
    padded to the max before the collective and trimmed after.
    Single-process: no-op."""
    if process_count() == 1:
        return feats
    bmax = max(block_sizes)
    out = {}
    for k, v in feats.items():
        pad = np.zeros((bmax - v.shape[0],) + v.shape[1:], v.dtype)
        g = process_allgather(np.concatenate([v, pad], axis=0))
        out[k] = np.concatenate([g[i, :block_sizes[i]]
                                 for i in range(len(block_sizes))], axis=0)
    return out


def frames_from_features(feats: dict, stamps: np.ndarray):
    """The per-frame Frames of a feature stream, in order."""
    for i in range(len(stamps)):
        nk = int(feats["n_kpts"][i])
        yield Frame(stamp=float(stamps[i]), frame_id=i,
                    kpts=feats["kpts"][i, :nk].astype(np.float32),
                    kpts3d=feats["pts3d"][i, :nk].astype(np.float32),
                    desc=feats["desc"][i, :nk])


def vo_from_features(feats: dict, stamps: np.ndarray,
                     camera: StereoCameraModel, cfg: SlamConfig,
                     device="cuda", draws_fn=None,
                     record: list | None = None) -> np.ndarray:
    """Sequential VO over a gathered feature stream -> (N,4,4) poses,
    its registrations on `device` (K6 on the card).  `draws_fn(seed)`,
    when set, supplies the RANSAC uniforms (tests pass tpuslam's);
    `record`, when a list, receives each (frame, OdomInfo).

    Deterministic: every process that runs this on identical features
    produces identical trajectories."""
    odom = Odometry(camera, cfg.odometry, cfg.matching, cfg.pnp,
                    device=device, draws_fn=draws_fn)
    poses = []
    for frame in frames_from_features(feats, stamps):
        info = odom.process(frame)
        poses.append(np.asarray(info.pose))
        if record is not None:
            record.append((frame, info))
    return np.stack(poses)


def run_multihost_vo(lefts: np.ndarray, rights: np.ndarray,
                     stamps: np.ndarray, camera: StereoCameraModel,
                     cfg: SlamConfig, shapes: FusedShapes = FusedShapes(),
                     device="cuda",
                     record: list | None = None) -> np.ndarray:
    """Full multi-process pipeline on `device` (the card unless the
    caller asks for the CPU): shard frames -> extract local features ->
    all-gather -> identical VO everywhere (`record` as
    `vo_from_features`'s).

    `lefts`/`rights` hold the FULL sequence on every process (each
    process reads only its block)."""
    n = len(stamps)
    p = process_count()
    blocks = [frame_block(n, p, i) for i in range(p)]
    mine = blocks[process_index()]
    feats = extract_block_features(lefts[mine], rights[mine], camera, cfg,
                                   shapes, device)
    feats = allgather_features(feats, [b.stop - b.start for b in blocks])
    return vo_from_features(feats, stamps, camera, cfg, device,
                            record=record)
