"""Checkpoint / resume of the full SLAM state.

Counterpart of tpuslam/runtime/checkpoint.py, in the same format: one .npz
of flat arrays (no pickle) with the same keys and FORMAT_VERSION, so a
file written by either package loads in the other.  It holds the complete
Mapper memory (nodes with features + decimated disparity, links, the
visual-word dictionary, STM/WM and counters) and the odometry state, so a
batch run can stop after frame k and continue to identical results: the
RANSAC seeds are the odometry's frames_processed and the nodes' ids, and
both are restored.

Where the port differs: a tensor is brought to the host with
`.cpu().numpy()`; save_state joins a loop-closure worker still in flight
first, so its link is saved; load_state rebuilds the dictionary on the
Mapper's device (its device copy re-uploaded at first use) and leaves no
worker in flight.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mapping.dictionary import VisualWord, VWDictionary
from ..mapping.graph import Link, Node
from ..vo.frame import Frame

FORMAT_VERSION = 1


def _np(a) -> np.ndarray:
    """A tensor or array-like as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _frame_blobs(frame: Frame) -> dict:
    return {
        "kpts": _np(frame.kpts).astype(np.float32),
        "kpts3d": _np(frame.kpts3d).astype(np.float32),
        "desc": _np(frame.desc).astype(np.uint8),
        "stamp": np.float64(frame.stamp),
        "frame_id": np.int64(frame.frame_id),
        "disp": (_np(frame.disparity_dec)
                 if frame.disparity_dec is not None
                 else np.zeros((0, 0), np.int16)),
        "disp_scale": np.int64(frame.disp_scale),
        "gt": (_np(frame.gt_pose).astype(np.float64)
               if frame.gt_pose is not None else np.zeros((0, 0))),
    }


def _frame_from_blobs(b: dict) -> Frame:
    disp = b["disp"]
    gt = b["gt"]
    return Frame(stamp=float(b["stamp"]), frame_id=int(b["frame_id"]),
                 kpts=b["kpts"], kpts3d=b["kpts3d"], desc=b["desc"],
                 disparity_dec=disp if disp.size else None,
                 disp_scale=int(b["disp_scale"]),
                 gt_pose=gt if gt.size else None)


def save_state(path: str, mapper, odometry=None) -> None:
    """Serialize mapper (+ optional odometry) state to `path` (.npz)."""
    mapper.join_loop_closure()
    out: dict[str, np.ndarray] = {"version": np.int64(FORMAT_VERSION)}

    node_ids = sorted(mapper.nodes)
    out["node_ids"] = np.array(node_ids, np.int64)
    out["node_map_ids"] = np.array(
        [mapper.nodes[i].map_id for i in node_ids], np.int64)
    out["node_weights"] = np.array(
        [mapper.nodes[i].weight for i in node_ids], np.int64)
    out["node_poses"] = (np.stack([_np(mapper.nodes[i].pose)
                                   for i in node_ids])
                         if node_ids else np.zeros((0, 4, 4)))
    vel = np.full((len(node_ids), 6), np.nan, np.float64)
    for k, i in enumerate(node_ids):
        v = mapper.nodes[i].velocity
        if v is not None:
            vel[k] = _np(v)
    out["node_velocities"] = vel

    # ragged per-node frame features: concat + offsets
    kpts, kpts3d, descs, offsets = [], [], [], [0]
    disp_list, disp_node_idx = [], []
    stamps, frame_ids, disp_scales = [], [], []
    gts, gt_node_idx = [], []
    for k, i in enumerate(node_ids):
        f = mapper.nodes[i].frame
        b = _frame_blobs(f)
        kpts.append(b["kpts"])
        kpts3d.append(b["kpts3d"])
        descs.append(b["desc"])
        offsets.append(offsets[-1] + len(b["kpts"]))
        stamps.append(b["stamp"])
        frame_ids.append(b["frame_id"])
        disp_scales.append(b["disp_scale"])
        if f.disparity_dec is not None:
            disp_list.append(b["disp"])
            disp_node_idx.append(k)
        if f.gt_pose is not None:
            gts.append(b["gt"])
            gt_node_idx.append(k)
    out["frame_kpts"] = (np.concatenate(kpts) if kpts
                         else np.zeros((0, 3), np.float32))
    out["frame_kpts3d"] = (np.concatenate(kpts3d) if kpts3d
                           else np.zeros((0, 3), np.float32))
    out["frame_desc"] = (np.concatenate(descs) if descs
                         else np.zeros((0, 32), np.uint8))
    out["frame_offsets"] = np.array(offsets, np.int64)
    out["frame_stamps"] = np.array(stamps, np.float64)
    out["frame_ids"] = np.array(frame_ids, np.int64)
    out["frame_disp_scales"] = np.array(disp_scales, np.int64)
    out["disp_maps"] = (np.stack(disp_list) if disp_list
                        else np.zeros((0, 0, 0), np.int16))
    out["disp_node_idx"] = np.array(disp_node_idx, np.int64)
    out["gt_poses"] = (np.stack(gts) if gts else np.zeros((0, 4, 4)))
    out["gt_node_idx"] = np.array(gt_node_idx, np.int64)

    # node word multimaps: (node_id, word_id, kpt_idx) triples in order
    trip = [(i, w, k) for i in node_ids for (w, k) in mapper.nodes[i].words]
    out["node_words"] = np.array(trip, np.int64).reshape(-1, 3)

    # links (owned per node): (from, to, type) + transforms + infos
    lf, lt, ltype, ltrans, linfo = [], [], [], [], []
    for i in node_ids:
        for _, link in mapper.nodes[i].links.items():
            lf.append(link.from_id)
            lt.append(link.to_id)
            ltype.append(link.type)
            ltrans.append(_np(link.transform).astype(np.float64))
            linfo.append(_np(link.info).astype(np.float64))
    out["link_from"] = np.array(lf, np.int64)
    out["link_to"] = np.array(lt, np.int64)
    out["link_type"] = np.array(ltype, np.int64)
    out["link_transform"] = (np.stack(ltrans) if ltrans
                             else np.zeros((0, 4, 4)))
    out["link_info"] = np.stack(linfo) if linfo else np.zeros((0, 6, 6))

    # memory management state
    out["stm"] = np.array(mapper.stm, np.int64)
    out["wm_ids"] = np.array(sorted(mapper.working_mem), np.int64)
    out["wm_counters"] = np.array(
        [mapper.working_mem[i] for i in sorted(mapper.working_mem)],
        np.int64)
    out["counters"] = np.array([
        mapper._id_count, mapper._id_map_count, mapper._frame_processed,
        mapper._intermediate_count, mapper._wm_counter,
        mapper.last_node.id if mapper.last_node is not None else -1,
    ], np.int64)
    out["loop_closures"] = np.array(mapper.loop_closures,
                                    np.int64).reshape(-1, 2)

    # dictionary
    wids = sorted(mapper.vwd.words)
    out["word_ids"] = np.array(wids, np.int64)
    out["word_desc"] = (np.stack(
        [_np(mapper.vwd.words[w].descriptor) for w in wids]).astype(
            np.uint8) if wids else np.zeros((0, 32), np.uint8))
    refs = [(w, n, c) for w in wids
            for n, c in mapper.vwd.words[w].references.items()]
    out["word_refs"] = np.array(refs, np.int64).reshape(-1, 3)
    out["last_word_id"] = np.int64(mapper.vwd._last_word_id)

    # odometry
    out["has_odom"] = np.int64(odometry is not None)
    if odometry is not None:
        out["odom_pose"] = _np(odometry.pose).astype(np.float64)
        out["odom_velocity"] = (
            _np(odometry.velocity_guess).astype(np.float64)
            if odometry.velocity_guess is not None
            else np.full(6, np.nan))
        out["odom_scalars"] = np.array([
            odometry.previous_stamp, odometry.frames_processed,
            odometry.num_objects, odometry.distance_travelled,
        ], np.float64)
        out["odom_state"] = np.array(
            ["Initialized", "Running", "Lost"].index(odometry.state),
            np.int64)
        out["odom_kf_pose"] = (
            _np(odometry.last_keyframe_pose).astype(np.float64)
            if odometry.last_keyframe_pose is not None
            else np.zeros((0, 0)))
        if odometry.ref_frame is not None:
            for k, v in _frame_blobs(odometry.ref_frame).items():
                out[f"odom_ref_{k}"] = v
    np.savez_compressed(path, **out)


def load_state(path: str, mapper, odometry=None) -> None:
    """Restore state saved by save_state (of either package) into fresh
    Mapper/Odometry instances (constructed by the caller with the same
    camera/config)."""
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format {int(z['version'])}, "
                         f"expected {FORMAT_VERSION}")

    node_ids = z["node_ids"]
    offsets = z["frame_offsets"]
    disp_by_idx = {int(k): z["disp_maps"][j]
                   for j, k in enumerate(z["disp_node_idx"])}
    gt_by_idx = {int(k): z["gt_poses"][j]
                 for j, k in enumerate(z["gt_node_idx"])}

    mapper.nodes = {}
    for k, nid in enumerate(node_ids):
        lo, hi = int(offsets[k]), int(offsets[k + 1])
        f = Frame(stamp=float(z["frame_stamps"][k]),
                  frame_id=int(z["frame_ids"][k]),
                  kpts=z["frame_kpts"][lo:hi],
                  kpts3d=z["frame_kpts3d"][lo:hi],
                  desc=z["frame_desc"][lo:hi],
                  disparity_dec=disp_by_idx.get(k),
                  disp_scale=int(z["frame_disp_scales"][k]),
                  gt_pose=gt_by_idx.get(k))
        node = Node(int(nid), int(z["node_map_ids"][k]),
                    int(z["node_weights"][k]), z["node_poses"][k], f)
        v = z["node_velocities"][k]
        node.velocity = None if np.isnan(v).any() else v
        mapper.nodes[int(nid)] = node

    for nid, wid, kidx in z["node_words"]:
        mapper.nodes[int(nid)].words.append((int(wid), int(kidx)))

    for j in range(len(z["link_from"])):
        link = Link(int(z["link_from"][j]), int(z["link_to"][j]),
                    int(z["link_type"][j]), z["link_transform"][j],
                    z["link_info"][j])
        mapper.nodes[link.from_id].links.insert(link.to_id, link)

    mapper.stm = [int(i) for i in z["stm"]]
    mapper.working_mem = {int(i): int(c) for i, c in
                          zip(z["wm_ids"], z["wm_counters"])}
    (mapper._id_count, mapper._id_map_count, mapper._frame_processed,
     mapper._intermediate_count, mapper._wm_counter, last_id) = \
        (int(v) for v in z["counters"])
    mapper.last_node = mapper.nodes.get(last_id)
    mapper.loop_closures = [(int(a), int(b))
                            for a, b in z["loop_closures"]]
    mapper.word_precomputed = {}
    mapper._lc_thread = None
    mapper._lc_result = [None, None]

    vwd = VWDictionary(mapper.vwd.nndr, mapper.vwd.device)
    for j, wid in enumerate(z["word_ids"]):
        vw = VisualWord(int(wid), z["word_desc"][j], 0)
        vwd.words[int(wid)] = vw
    for wid, nid, cnt in z["word_refs"]:
        vw = vwd.words[int(wid)]
        vw.references[int(nid)] = int(cnt)
        vw.total_references += int(cnt)
    vwd._last_word_id = int(z["last_word_id"])
    n_words = len(vwd.words)
    if n_words:
        vwd._grow(n_words)
        vwd._train[:n_words] = z["word_desc"].astype(np.float32)
        vwd._word_ids[:n_words] = z["word_ids"]
    vwd._count = n_words
    vwd._dev_dirty = True            # the device copy re-uploads at first use
    mapper.vwd = vwd

    if odometry is not None and int(z["has_odom"]):
        odometry.pose = z["odom_pose"]
        v = z["odom_velocity"]
        odometry.velocity_guess = None if np.isnan(v).any() else \
            v.astype(np.float32)
        (odometry.previous_stamp, fp, no, dt) = z["odom_scalars"]
        odometry.frames_processed = int(fp)
        odometry.num_objects = int(no)
        odometry.distance_travelled = float(dt)
        odometry.state = ["Initialized", "Running", "Lost"][
            int(z["odom_state"])]
        if "odom_ref_kpts" in z.files:
            odometry.ref_frame = _frame_from_blobs(
                {k[len("odom_ref_"):]: z[k] for k in z.files
                 if k.startswith("odom_ref_")})
        kf = z["odom_kf_pose"]
        odometry.last_keyframe_pose = kf if kf.size else None
