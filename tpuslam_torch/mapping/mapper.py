"""Keyframe memory manager with bag-of-words loop closure, in PyTorch.

Counterpart of tpuslam/mapping/mapper.py (the reference's Mapper.cpp),
with the port's dictionary and registration:

  * every frame becomes a node; only every `map_update`-th (5) is a full
    node, others are intermediate (weight -1, features cleared)
    (Mapper.cpp:71-86),
  * consecutive nodes linked with a diagonal information matrix 1/cov
    (addNodeToStm:291-317),
  * STM -> WM transfer past 30 non-intermediate nodes (:257-323),
  * per full node: dictionary update (addWordIds, word cap 750 by
    response, :413-484) then tf-idf loop-closure likelihood over the WM
    (computeLikelihood, Angeli-2008, :606-677), hypothesis >= 0.2 =>
    LC registration (global matching, no guess) and link insertion
    (:536-604).

The reference runs the dictionary/LC step on a worker thread joined at
the next full node (Mapper.cpp:94-124); with `async_lc` so does this one,
else it runs synchronously; the final graph is identical.  The
dictionary search and the loop-closure registration run on `device` (the
card unless the caller asks for the CPU; FastSlamPipeline sets its own
device), from the worker thread too.  `draws_fn(seed)`, when set, supplies
each registration's RANSAC uniforms (tests pass tpuslam's).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MapperConfig, MatchingConfig, PnPConfig
from ..geometry import transform as T
from ..geometry.camera import StereoCameraModel
from ..runtime import perf
from ..vo.frame import Frame, limit_keypoints
from ..vo.registration import compute_transform
from .dictionary import VWDictionary
from .graph import Link, MultiMap, Node, NEIGHBOR, LOOP_CLOSURE, find_link


class Mapper:
    # the chunked pipeline may precompute dictionary decisions with the
    # per-chunk device program (mapping/chunk_dict.py); the sharded
    # dictionary of PartitionedMapper opts out
    device_dict_ok = True

    def __init__(self, camera: StereoCameraModel,
                 cfg: MapperConfig = MapperConfig(),
                 matching_cfg: MatchingConfig = MatchingConfig(),
                 pnp_cfg: PnPConfig = PnPConfig(), device="cuda"):
        self.camera = camera
        self.cfg = cfg
        self.matching_cfg = matching_cfg
        self.pnp_cfg = pnp_cfg

        self.nodes: dict[int, Node] = {}
        self.stm: list[int] = []       # ordered set (ids ascend)
        self.working_mem: dict[int, int] = {}  # id -> insertion counter
        self.vwd = VWDictionary(cfg.dict_nndr, device)
        self._id_count = 0
        self._id_map_count = 0
        self._frame_processed = 0
        self._intermediate_count = 0
        self._wm_counter = 0
        self.last_node: Node | None = None
        self.loop_closures: list[tuple[int, int]] = []  # (from,to) accepted
        # frame_id -> (keep, unique, i1_rows, count_after) decisions
        # precomputed by the per-chunk device dictionary program
        # (mapping/chunk_dict.py); consumed by _add_word_ids
        self.word_precomputed: dict[int, tuple] = {}
        self.async_lc = False            # realtime mode: LC on a worker
        self._lc_thread = None
        self._lc_result: list = [None, None]
        self.draws_fn = None             # seed -> RANSAC uniforms (tests)

    @property
    def device(self) -> torch.device:
        return self.vwd.device

    @device.setter
    def device(self, dev) -> None:
        self.vwd.device = torch.device(dev)
        self.vwd._dev_dirty = True

    # -- Mapper::process (Mapper.cpp:71-129) ------------------------------
    def process(self, frame: Frame, odom_info) -> None:
        if self._intermediate_count >= self.cfg.map_update - 1:
            self._intermediate_count = 0
            intermediate = False
        else:
            self._intermediate_count += 1
            intermediate = True

        if not intermediate:
            # join the previous cycle's loop-closure worker and collect
            # its link BEFORE touching shared state (Mapper.cpp:97-106)
            self.join_loop_closure()

        node = self._create_node(frame, odom_info, intermediate)
        self._update_memory(node, odom_info.covariance)

        if not intermediate:
            if self.async_lc:
                # dictionary + loop closure on a worker thread,
                # overlapped with the next map_update frames of odometry
                # (Mapper.cpp:107-124, xThread.cpp:15-44)
                import threading
                self._lc_result = [None, None]   # link, error
                # the worker runs on this thread's card ("cuda" without
                # an index names the calling thread's current device)
                dev = self.device
                if dev.type == "cuda" and dev.index is None:
                    dev = torch.device("cuda", torch.cuda.current_device())
                self._lc_thread = threading.Thread(
                    target=self._lc_worker,
                    args=(node, self._lc_result, dev), daemon=True)
                self._lc_thread.start()
            else:
                with perf.span("lc.search"):
                    link = self._dictionary_and_loop_closure(node)
                if link is not None:
                    self.add_link(link)

        self._frame_processed += 1

    def _lc_worker(self, node: Node, result: list, dev: torch.device):
        with perf.span("lc.search"):
            try:
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                result[0] = self._dictionary_and_loop_closure(node)
            except BaseException as e:   # re-raised by join_loop_closure
                result[1] = e

    def join_loop_closure(self) -> None:
        """Join a pending async loop-closure worker and insert its link
        (the reference's join-before-reuse, Mapper.cpp:97-106).  An error
        raised on the worker is raised here."""
        if self._lc_thread is None:
            return
        with perf.span("lc.join"):
            self._lc_thread.join()
            self._lc_thread = None
            link, err = self._lc_result
            self._lc_result = [None, None]
            if err is not None:
                raise err
            if link is not None:
                self.add_link(link)

    def memory_used(self) -> dict[str, int]:
        """Component byte usage (Mapper::registerMemoryUsed twin,
        Mapper.cpp:486-505)."""
        nodes = sum(n.frame.memory_used() for n in self.nodes.values())
        words = sum(w.descriptor.nbytes for w in self.vwd.words.values())
        index = self.vwd._train.nbytes + self.vwd._word_ids.nbytes
        return {"Mapper.nodes": nodes, "Mapper.words": words,
                "Mapper.index": index}

    # -- Mapper::createNode (Mapper.cpp:392-411) --------------------------
    def _create_node(self, frame: Frame, odom_info,
                     intermediate: bool) -> Node:
        # The reference's C++ value semantics give the node its OWN
        # SensorData copy (clearRawData/clearFeatures there don't touch
        # the odometry's keyframe).  Mirror that with a shallow copy —
        # attribute reassignment in clear_* stays copy-local while the
        # arrays themselves are shared until cleared.
        import copy
        node_frame = copy.copy(frame)
        node_frame.set_decimated_disparity()  # SensorData.cpp:50-58
        node_frame.clear_raw_data()
        if intermediate:
            node_frame.clear_features()
        self._id_count += 1
        node = Node(self._id_count, self._id_map_count,
                    -1 if intermediate else 0, odom_info.pose.copy(),
                    node_frame)
        node.velocity = odom_info.velocity
        return node

    # -- Mapper::updateMemory / addNodeToStm (Mapper.cpp:257-323) ---------
    def _update_memory(self, node: Node, covariance: np.ndarray):
        if self.stm:
            prev_id = self.stm[-1]
            prev = self.nodes[prev_id]
            motion = T.compose(T.inverse(prev.pose), node.pose)
            info = np.zeros((6, 6), np.float64)
            for i in range(6):
                info[i, i] = 1.0 / covariance[i, i]
            fwd = Link(prev_id, node.id, NEIGHBOR, motion, info)
            prev.add_link(fwd)
            node.add_link(Link(node.id, prev_id, NEIGHBOR,
                               T.inverse(motion), info))

        self.nodes[node.id] = node
        self.stm.append(node.id)
        self.last_node = node

        n_full = sum(1 for i in self.stm
                     if self.nodes[i].weight >= 0)
        while (self.stm and self.cfg.max_stm_size > 0 and
               n_full > self.cfg.max_stm_size):
            oldest = self.stm[0]
            if self.nodes[oldest].weight >= 0:
                n_full -= 1
            self.working_mem[oldest] = self._wm_counter
            self._wm_counter += 1
            self.stm.pop(0)

    # -- Mapper::addLink (Mapper.cpp:371-390) -----------------------------
    def add_link(self, link: Link):
        to = self.nodes.get(link.to_id)
        frm = self.nodes.get(link.from_id)
        if to is not None and frm is not None:
            if to.has_link(link.from_id):
                return
            to.add_link(link.inverse())
            frm.add_link(link)
            frm.weight = frm.weight + to.weight
            to.weight = 0

    # -- addWordIds (Mapper.cpp:413-484) ----------------------------------
    def _add_word_ids(self, node: Node):
        desc = node.frame.desc
        n = len(desc)
        max_features = self.cfg.max_features_per_node

        pre = self.word_precomputed.pop(node.frame.frame_id, None)
        if pre is not None and n:
            # device-precomputed path (chunk_dict.py): keep mask +
            # uniqueness decided on device against the same state; the
            # host replays the bookkeeping only
            keep, unique, i1_rows, count_after = pre
            inliers = np.asarray(keep[:n], bool)
            added = self.vwd.apply_precomputed(desc[inliers], node.id,
                                               unique, i1_rows)
            assert self.vwd._count == int(count_after), \
                "device dictionary drifted from host bookkeeping"
            word_ids = []
            it = iter(added)
            neg = -1
            for i in range(n):
                if inliers[i]:
                    word_ids.append(next(it))
                else:
                    word_ids.append(neg)
                    neg -= 1
        elif n > max_features:
            inliers = limit_keypoints(node.frame.kpts[:, 2], max_features)
            added = self.vwd.add_new_words(desc[inliers], node.id)
            word_ids = []
            it = iter(added)
            neg = -1
            for i in range(n):
                if inliers[i]:
                    word_ids.append(next(it))
                else:
                    word_ids.append(neg)
                    neg -= 1
        else:
            word_ids = self.vwd.add_new_words(desc, node.id)

        # words multimap <word id, keypoint index>, sorted by word id
        node.words = sorted((w, i) for i, w in enumerate(word_ids))

    # -- detectLoopClosure (Mapper.cpp:536-604) ---------------------------
    def _dictionary_and_loop_closure(self, node: Node) -> Link | None:
        self._add_word_ids(node)

        if node.weight < 0 or not self.working_mem:
            return None

        candidates = [i for i in self.working_mem
                      if self.nodes[i].weight != -1]
        likelihood = self.compute_likelihood(node, candidates)

        best_id, best_val = 0, 0.0
        for nid, val in likelihood.items():
            if nid > 0 and val > best_val:
                best_id, best_val = nid, val

        if best_val < self.cfg.loop_thr:
            return None

        frame_from = self.nodes[best_id].frame
        frame_to = node.frame
        tf, reg = compute_transform(
            frame_from, frame_to, None, self.camera,
            nndr=self.matching_cfg.nndr,
            min_inliers=self.pnp_cfg.min_inliers,
            refine_iterations=self.pnp_cfg.refine_iterations,
            seed=node.id, device=self.device,
            draws=None if self.draws_fn is None else self.draws_fn(node.id))
        if tf is None:
            return None

        tf = T.inverse(tf)
        information = np.linalg.inv(reg.covariance)
        self.loop_closures.append((node.id, best_id))
        return Link(node.id, best_id, LOOP_CLOSURE, tf, information)

    # -- computeLikelihood (Mapper.cpp:606-677) ---------------------------
    def compute_likelihood(self, node: Node,
                           ids: list[int]) -> dict[int, float]:
        likelihood = {i: 0.0 for i in ids}
        if not likelihood:
            return likelihood

        # unique word ids of this node (consecutive dedup on sorted words)
        word_ids = []
        last = None
        for w, _ in node.words:
            if last is None or w != last:
                word_ids.append(w)
                last = w

        N = float(len(self.nodes))
        if N:
            for w in word_ids:
                # the reference requires id > 0 (Mapper.cpp:632): negative
                # ids are non-dictionary keypoints, and word id 0 (the
                # first word ever) is excluded by the same strict test
                if w <= 0:
                    continue
                vw = self.vwd.get_word(w)
                if vw is None:
                    continue
                refs = vw.references
                nw = float(len(refs))
                log_nnw = np.log10(N / nw)
                if log_nnw:
                    for ref_node_id, nwi in refs.items():
                        if ref_node_id in likelihood:
                            ref_node = self.nodes.get(ref_node_id)
                            if ref_node is not None:
                                ni = len(ref_node.words)
                                if ni:
                                    likelihood[ref_node_id] += \
                                        (float(nwi) * log_nnw) / ni
        return likelihood

    # -- Mapper::getGraph (Mapper.cpp:131-186) ----------------------------
    def get_graph(self):
        """BFS from the last node; returns (poses dict, links MultiMap)."""
        self.join_loop_closure()
        ids: set[int] = set()
        next_ids = {self.last_node.id}
        while next_ids:
            current = sorted(next_ids, reverse=True)
            next_ids = set()
            for nid in current:
                ids.add(nid)
                for other_id, _ in self.nodes[nid].links.items():
                    if other_id not in ids:
                        next_ids.add(other_id)

        poses = {}
        links = MultiMap()
        for nid in sorted(ids):
            poses[nid] = self.nodes[nid].pose
            for _, link in self.nodes[nid].links.items():
                if find_link(links, nid, link.to_id) is None:
                    links.insert(nid, link)
        return poses, links
