"""One rank of a P-process run of the multi-device layer, written to
OUT_DIR/rank{R}.npz:

    python -m tpuslam_torch.tools.dist_worker SEQ_DIR OUT_DIR HOST:PORT \
        P R [--device cuda|cpu] [--backend gloo|nccl] [--chunk 30]

(P = 1 runs without a process group.)  The rank

  * runs the front-end-sharded VO (dist/multihost.run_multihost_vo) over
    the KITTI-layout sequence SEQ_DIR: poses;
  * runs the dense and the sparse sharded pose-graph steps on the GLOBAL
    mesh (P ranks x LOCAL_SHARDS shards, axis "edges") over a noisy
    8-vertex chain (seed 0), its edges padded to the global shard count:
    opt_poses/chis and sp_opt_poses/sp_chis;
  * runs the sharded dictionary top-2 on the global mesh (axis "words")
    over random integer descriptors: top2_equal (to one unsharded
    search, bit for bit) and top2_w1;
  * feeds the gathered stream with its odometry to a PartitionedMapper
    and to a plain Mapper at MapperConfig(map_update=1, max_stm_size=2)
    (every node full, so node ids alternate owners), recording each
    node's loop-closure likelihoods: their words, links, link transforms
    and likelihoods, the owned words and feature bytes.

Beside them: `launches` and `collectives` (JSON, per part: vo,
pose_graph, dict_top2, map; the kernel launch counters and the
collectives issued, each reset before its part), `seconds` (JSON, each
part's wall), `built_s` (JSON, on the card: each kernel library's build
seconds in this process, 0.0 where it was built already) and
`map_bytes` (JSON, the PartitionedMapper's memory_used()).  The keys of
the results are those of the JAX suite's tests/_multihost_worker.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import MapperConfig, SlamConfig
from ..dist import mesh as M
from ..dist import multihost as mh
from ..dist.partitioned_map import PartitionedMapper
from ..geometry.camera import StereoCameraModel
from ..io.dataset import StereoImageDataset
from ..io.png import image_size
from ..kernels import _cuda
from ..mapping.mapper import Mapper
from ..optim import device as dev
from ..vo.fused import FusedShapes

# shards per process, as the JAX suite's worker's two devices per process
LOCAL_SHARDS = 2


def noisy_chain(n_v: int = 8, seed: int = 0):
    """tests/_multihost_worker.py's chain: (noisy poses, e_from, e_to, Z,
    Omega, free_idx), vertex 0 fixed."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(n_v - 1):
        step = np.eye(4, dtype=np.float32)
        step[:3, 3] = [1.0, 0.1 * rng.standard_normal(), 0.0]
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    noisy = gt.copy()
    noisy[1:, :3, 3] += 0.05 * rng.standard_normal((n_v - 1, 3))
    e_from = np.arange(n_v - 1, dtype=np.int32)
    e_to = e_from + 1
    Z = np.stack([np.linalg.inv(gt[a]) @ gt[b]
                  for a, b in zip(e_from, e_to)]).astype(np.float32)
    Omega = np.tile(np.eye(6, dtype=np.float32), (n_v - 1, 1, 1))
    free_idx = np.full(n_v, -1, np.int32)
    free_idx[1:] = np.arange(n_v - 1)
    return noisy, e_from, e_to, Z, Omega, free_idx


def _lik_flat(trace):
    ids = [nid for nid, kv in trace for _ in kv]
    cands = [c for _, kv in trace for c, _ in kv]
    vals = [v for _, kv in trace for _, v in kv]
    return (np.asarray(ids, np.int64), np.asarray(cands, np.int64),
            np.asarray(vals, np.float64))


def links_flat(mapper):
    """(from, to, type) rows of the mapper's graph and their transforms,
    in a fixed order."""
    _, links = mapper.get_graph()
    rows = sorted((f, lk.to_id, lk.type) for f in links.keys()
                  for lk in links.get(f))
    tfs = []
    for f in links.keys():
        for lk in sorted(links.get(f), key=lambda x: (x.to_id, x.type)):
            tfs.append(np.asarray(lk.transform, np.float64))
    return (np.asarray(rows, np.int64).reshape(-1, 3),
            np.stack(tfs) if tfs else np.zeros((0, 4, 4)))


def words_flat(mapper):
    """(node id, word id, keypoint) rows of every full node's words."""
    rows = []
    for nid in sorted(mapper.nodes):
        node = mapper.nodes[nid]
        if node.weight >= 0 and node.words:
            rows.extend((nid, w, k) for w, k in node.words)
    return np.asarray(rows, np.int64).reshape(-1, 3)


class _Part:
    """Counters reset, wall clock started; read on exit."""

    def __init__(self, name, device, out):
        self.name, self.device, self.out = name, device, out

    def __enter__(self):
        _cuda.reset_counters()
        M.reset_collectives()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        self.out["seconds"][self.name] = time.perf_counter() - self.t0
        self.out["launches"][self.name] = dict(_cuda.LAUNCHES)
        self.out["plain"][self.name] = dict(_cuda.PLAIN_CALLS)
        self.out["collectives"][self.name] = dict(M.COLLECTIVES)


def run_rank(seq: str, device="cuda", chunk: int = 30) -> dict:
    """This rank's results (see the module docstring)."""
    meta = dict(seconds={}, launches={}, plain={}, collectives={})
    # on the card, the seconds each kernel library took to build here (0.0:
    # it was built already, as by chip_smoke.py's build phase, and only
    # loaded)
    meta["built_s"] = _cuda.build_all() \
        if torch.device(device).type == "cuda" else {}
    cfg = SlamConfig()
    left_dir = os.path.join(seq, "image_0")
    ds = StereoImageDataset(left_dir=left_dir,
                            right_dir=os.path.join(seq, "image_1"),
                            times_path=os.path.join(seq, "times.txt"))
    camera = StereoCameraModel.load_kitti(
        os.path.join(seq, "calib.txt"),
        image_size=image_size(os.path.join(left_dir, ds._left[0])))
    items = [ds[i] for i in range(len(ds))]
    lefts = np.stack([it["left"] for it in items])
    rights = np.stack([it["right"] for it in items])
    stamps = np.array([it["stamp"] for it in items])

    record = []
    with _Part("vo", device, meta):
        poses = mh.run_multihost_vo(lefts, rights, stamps, camera, cfg,
                                    FusedShapes(chunk=chunk), device,
                                    record=record)

    # the sharded pose-graph steps on the GLOBAL mesh
    mesh = M.make_mesh(LOCAL_SHARDS, axis="edges", device=device)
    noisy, e_from, e_to, Z, Omega, free_idx = noisy_chain()
    n_v = len(noisy)
    xsel, xp, xq = dev.classify_extra_edges(e_from, e_to, free_idx)
    ef, et, Zp, Op = M.pad_edges(e_from, e_to, Z, Omega, mesh.size)
    xsel_p = np.full(len(ef), -1, np.int32)
    xsel_p[:len(xsel)] = xsel
    with _Part("pose_graph", device, meta):
        opt_poses, chis = M.sharded_pose_graph_step(
            mesh, n_v, n_v - 1, iterations=5)(noisy, ef, et, Zp, Op,
                                              free_idx)
        sp_poses, sp_chis = M.sharded_pose_graph_step_sparse(
            mesh, n_v - 1, iterations=5)(noisy, ef, et, Zp, Op, free_idx,
                                         xsel_p, xp, xq)

    # the sharded dictionary top-2 on the global mesh against one
    # unsharded search of the same rows (integer descriptors: exact)
    wmesh = M.make_mesh(LOCAL_SHARDS, axis="words", device=device)
    rng = np.random.default_rng(1)
    n_words = 64 * wmesh.size
    train = rng.integers(0, 256, (n_words, 32)).astype(np.float32)
    query = train[rng.choice(n_words, 96)] + \
        rng.integers(0, 2, (96, 32)).astype(np.float32)
    wids = rng.permutation(4 * n_words)[:n_words].astype(np.int32)
    valid = rng.random(n_words) > 0.1
    with _Part("dict_top2", device, meta):
        top2 = M.sharded_dict_top2_step(wmesh)(query, train, wids, valid)
    whole = M.sharded_dict_top2_step(M.Mesh((wmesh.devices[0],), "words"))(
        query, train, wids, valid)
    top2_equal = all(torch.equal(a, b) for a, b in zip(top2, whole))

    # the partitioned map and a single-process Mapper over the same
    # gathered stream
    pcfg = dataclasses.replace(
        cfg, mapper=MapperConfig(map_update=1, max_stm_size=2))
    lik_pm, lik_sm = [], []

    class RecordingPM(PartitionedMapper):
        def _likelihood_allreduce(self, node, candidates):
            lik = super()._likelihood_allreduce(node, candidates)
            lik_pm.append((node.id, sorted(lik.items())))
            return lik

    class RecordingSM(Mapper):
        def compute_likelihood(self, node, ids):
            lik = super().compute_likelihood(node, ids)
            lik_sm.append((node.id, sorted(lik.items())))
            return lik

    with _Part("map", device, meta):
        pm = RecordingPM(camera, pcfg.mapper, pcfg.matching, pcfg.pnp,
                         device=device)
        for frame, info in record:
            pm.process(frame, info)
    sm = RecordingSM(camera, pcfg.mapper, pcfg.matching, pcfg.pnp,
                     device=device)
    for frame, info in record:
        sm.process(frame, info)

    pm_ids, pm_cands, pm_vals = _lik_flat(lik_pm)
    sm_ids, sm_cands, sm_vals = _lik_flat(lik_sm)
    pm_lrows, pm_ltfs = links_flat(pm)
    sm_lrows, sm_ltfs = links_flat(sm)

    def host(t):
        return t.cpu().numpy()

    return dict(
        poses=poses, opt_poses=host(opt_poses), chis=host(chis),
        sp_opt_poses=host(sp_poses), sp_chis=host(sp_chis),
        top2_equal=top2_equal, top2_w1=host(top2[1]),
        n_devices=mesh.size, total_words=len(pm.vwd),
        owned_words=np.sort(np.fromiter(pm.vwd.words.keys(), np.int64)),
        owned_feat_bytes=pm.owned_feature_bytes(),
        pm_lik_ids=pm_ids, pm_lik_cands=pm_cands, pm_lik=pm_vals,
        sm_lik_ids=sm_ids, sm_lik_cands=sm_cands, sm_lik=sm_vals,
        pm_links=pm_lrows, pm_link_tfs=pm_ltfs,
        sm_links=sm_lrows, sm_link_tfs=sm_ltfs,
        pm_words=words_flat(pm), sm_words=words_flat(sm),
        n_lc_pm=len(pm.loop_closures), n_lc_sm=len(sm.loop_closures),
        map_bytes=json.dumps(pm.memory_used()),
        **{k: json.dumps(v) for k, v in meta.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seq")
    ap.add_argument("out")
    ap.add_argument("coord")
    ap.add_argument("num_procs", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"])
    ap.add_argument("--chunk", type=int, default=30)
    a = ap.parse_args(argv)
    backend = mh.initialize(a.coord, a.num_procs, a.rank, a.backend,
                            a.device)
    try:
        res = run_rank(a.seq, a.device, a.chunk)
    finally:
        if backend is not None:
            dist.destroy_process_group()
    res["backend"] = str(backend)
    os.makedirs(a.out, exist_ok=True)
    np.savez(os.path.join(a.out, f"rank{a.rank}.npz"), **res)
    print(f"rank {a.rank} done: {len(res['poses'])} poses, "
          f"{res['n_devices']} global shards, {res['total_words']} words "
          f"({len(res['owned_words'])} owned), backend {backend}",
          flush=True)


if __name__ == "__main__":
    main()
