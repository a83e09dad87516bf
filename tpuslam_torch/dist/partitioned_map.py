"""Multi-process partitioned map: dictionary + keyframe features sharded
by rank.

Counterpart of tpuslam/dist/partitioned_map.py.  dist/multihost.py
shards the *front end* over processes; every rank then runs the whole
back end, so map memory (visual-word matrix, keyframe features) is
replicated.  This module partitions the persistent map state instead:

  * **visual words** are owned by rank `word_id % P`.  The incremental
    NNDR search (VWDictionary.cpp:40-115 semantics) becomes a sharded
    top-2: each rank searches its own word rows on its device, the
    per-rank two best (distance, word id) pairs cross processes (a few
    kB), and every rank merges them with the single-process tie-break
    (ascending distance, then ascending word id == insertion order).
    Word insertion order and ids equal the single-process dictionary's.
  * **tf-idf likelihood** (Mapper.cpp:606-677) is a sum over query words;
    each rank computes the partial over its owned words' reference maps
    and the partials are all-reduced (one (n_candidates,) f64 vector).
  * **keyframe features** are kept only by rank `node_id % P`; the
    loop-closure transform (Mapper.cpp:581-603) is computed by the
    candidate's owner (on its device: K6 on the card) and the accepted
    link is broadcast (one 4x4 + 6x6 per event).

Per-rank persistent map memory therefore scales ~1/P while the graph
bookkeeping stays replicated.  With P == 1 every collective is the
identity and behaviour equals mapping.Mapper.  The collectives go
through `comm`, any callable that all-gathers a numpy array into
(P, *shape) (tests inject a thread-lockstep one to run P = 2 in one
process); the default is multihost.process_allgather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MapperConfig, MatchingConfig, PnPConfig
from ..geometry import transform as T
from ..geometry.camera import StereoCameraModel
from ..mapping.dictionary import VisualWord, VWDictionary, _l2_top2_ids
from ..mapping.graph import Link, LOOP_CLOSURE
from ..mapping.mapper import Mapper
from ..vo.registration import compute_transform
from .multihost import process_allgather, process_count, process_index

BIG = np.float32(1e30)


# the default comm: (P, *arr.shape) across processes (leading dim 1
# single-process)
_allgather = process_allgather


def _comm_f64(comm, arr: np.ndarray) -> np.ndarray:
    """All-gather a float64 payload EXACTLY through `comm`: torch's
    collectives carry float64 as it is (tpuslam bit-casts it to uint32
    pairs, since its collectives downcast f64 with x64 off), so a
    near-threshold likelihood compares as on the single-process mapper."""
    return np.asarray(comm(np.ascontiguousarray(arr, np.float64)))


class ShardedVWDictionary(VWDictionary):
    """Rank-sharded twin of mapping.dictionary.VWDictionary.

    Owns the descriptor rows and VisualWord reference maps of words with
    `id % P == rank` (VWDictionary's row store, searched on `device`: the
    card unless the caller asks for the CPU); search results and
    insertion decisions are identical to the single-process dictionary.
    The chunk pipeline's replay (`apply_precomputed`) does not apply: a
    PartitionedMapper never takes the device dictionary."""

    def __init__(self, nndr: float = 0.8, rank: int | None = None,
                 world: int | None = None, comm=None, device="cuda"):
        super().__init__(nndr, device)
        self.rank = process_index() if rank is None else rank
        self.world = process_count() if world is None else world
        self.comm = comm or _allgather
        self._total_words = 0                    # global count

    def __len__(self):
        return self._total_words

    def clear(self):
        self.__init__(self.nndr, self.rank, self.world, self.comm,
                      self.device)

    def owned_bytes(self) -> int:
        return self._count * 32 * 4

    def _local_top2(self, desc_q: np.ndarray):
        """Two smallest squared-L2 (dist, global word id) pairs per query
        against the OWNED rows; (BIG, -1) where absent."""
        q = desc_q.shape[0]
        out = np.full((q, 2, 2), BIG, np.float32)
        out[:, :, 1] = -1.0
        if self._count == 0:
            return out
        self._sync_device()
        d1, i1, d2, i2 = (t.cpu().numpy() for t in _l2_top2_ids(
            torch.as_tensor(desc_q, device=self.device), self._train_dev,
            self._count))
        out[:, 0, 0] = d1
        out[:, 0, 1] = self._word_ids[i1.astype(np.int64)]
        if self._count >= 2:
            out[:, 1, 0] = d2
            out[:, 1, 1] = self._word_ids[i2.astype(np.int64)]
        return out

    def add_new_words(self, descriptors: np.ndarray,
                      node_id: int) -> list[int]:
        n = len(descriptors)
        if n == 0:
            return []
        desc_f = descriptors.astype(np.float32)

        have2 = self._total_words >= 2
        if have2:
            local = self._local_top2(desc_f)          # (n, 2, 2)
            alls = self.comm(local)                   # (P, n, 2, 2)
            cands = alls.reshape(-1, n, 2, 2)
            cands = np.concatenate([cands[i] for i in range(len(cands))],
                                   axis=1)            # (n, 2P, 2)
            # lexicographic (distance, word id) ascending == the single-
            # process first-minimum-row tie-break (rows are wid-ordered)
            order = np.lexsort((cands[:, :, 1], cands[:, :, 0]), axis=-1)
            top = np.take_along_axis(cands, order[:, :, None], axis=1)
            d1 = top[:, 0, 0]
            w1 = top[:, 0, 1].astype(np.int64)
            d2 = top[:, 1, 0]

        old_count = self._count
        word_ids: list[int] = []
        for k in range(n):
            unique = (not have2) or (d1[k] > np.float32(self.nndr) * d2[k])
            if unique:
                wid = self._last_word_id
                self._last_word_id += 1
                self._total_words += 1
                if wid % self.world == self.rank:
                    self.words[wid] = VisualWord(
                        wid, descriptors[k].copy(), node_id)
                    self._store_row(wid, desc_f[k])
                word_ids.append(wid)
            else:
                wid = int(w1[k])
                if wid % self.world == self.rank:
                    self.words[wid].add_ref(node_id)
                word_ids.append(wid)
        self._mirror_rows(old_count)
        return word_ids


class PartitionedMapper(Mapper):
    """Mapper with rank-partitioned persistent state, on `device` (the
    card unless the caller asks for the CPU).

    Every rank feeds the SAME deterministic frame stream (the
    multi-process pipeline all-gathers front-end features,
    dist/multihost.py); the collectives below therefore run in lock-step.
    Loop-closure work is synchronous (collectives cannot ride the async
    worker thread), and the chunk pipeline's device dictionary is not
    attached (`device_dict_ok`: the dictionary is searched per rank)."""

    device_dict_ok = False

    def __init__(self, camera: StereoCameraModel,
                 cfg: MapperConfig = MapperConfig(),
                 matching_cfg: MatchingConfig = MatchingConfig(),
                 pnp_cfg: PnPConfig = PnPConfig(),
                 rank: int | None = None, world: int | None = None,
                 comm=None, device="cuda"):
        super().__init__(camera, cfg, matching_cfg, pnp_cfg, device)
        self.rank = process_index() if rank is None else rank
        self.world = process_count() if world is None else world
        self.comm = comm or _allgather
        self.vwd = ShardedVWDictionary(cfg.dict_nndr, self.rank,
                                       self.world, comm=self.comm,
                                       device=device)

    # loop-closure collectives run in lock-step across ranks; executing
    # them on the async worker thread would deadlock or diverge ranks, so
    # the realtime `async_lc = True` pattern is rejected outright.
    @property
    def async_lc(self) -> bool:
        return False

    @async_lc.setter
    def async_lc(self, value: bool):
        if value:
            raise ValueError(
                "PartitionedMapper runs loop-closure collectives in "
                "lock-step across ranks; async_lc=True is unsupported")

    def owns_node(self, node_id: int) -> bool:
        return node_id % self.world == self.rank

    def owned_feature_bytes(self) -> int:
        total = 0
        for node in self.nodes.values():
            f = node.frame
            for arr in (f.kpts, f.kpts3d, f.desc, f.disparity_dec):
                if arr is not None:
                    total += arr.nbytes
        return total

    # -- partitioned detectLoopClosure ---------------------------------
    def _dictionary_and_loop_closure(self, node) -> Link | None:
        self._add_word_ids(node)

        link = None
        if node.weight >= 0 and self.working_mem:
            candidates = sorted(i for i in self.working_mem
                                if self.nodes[i].weight != -1)
            lik = self._likelihood_allreduce(node, candidates)

            best_id, best_val = 0, 0.0
            for nid, val in lik.items():
                if nid > 0 and val > best_val:
                    best_id, best_val = nid, val

            if best_val >= self.cfg.loop_thr:
                link = self._loop_transform_owner(node, best_id)

        # partition point: drop features of full nodes this rank does not
        # own (the dictionary/LC steps above were their last local use)
        if node.weight >= 0 and not self.owns_node(node.id):
            node.frame.clear_features()
            node.frame.disparity_dec = None
        return link

    def _likelihood_allreduce(self, node, candidates: list[int]):
        partial = np.zeros(len(candidates), np.float64)
        index = {nid: i for i, nid in enumerate(candidates)}
        word_ids = []
        last = None
        for w, _ in node.words:
            if last is None or w != last:
                word_ids.append(w)
                last = w
        N = float(len(self.nodes))
        if N:
            for w in word_ids:
                if w <= 0 or w % self.world != self.rank:
                    continue
                vw = self.vwd.get_word(w)
                if vw is None:
                    continue
                refs = vw.references
                nw = float(len(refs))
                log_nnw = np.log10(N / nw)
                if log_nnw:
                    for ref_node_id, nwi in refs.items():
                        i = index.get(ref_node_id)
                        if i is not None:
                            ref_node = self.nodes.get(ref_node_id)
                            if ref_node is not None and ref_node.words:
                                partial[i] += (float(nwi) * log_nnw) / \
                                    len(ref_node.words)
        total = _comm_f64(self.comm, partial).sum(axis=0)
        return {nid: float(total[i]) for i, nid in enumerate(candidates)}

    def _loop_transform_owner(self, node, best_id: int) -> Link | None:
        """LC transform computed on the candidate's owner, broadcast."""
        payload = np.zeros(1 + 16 + 36, np.float64)
        if self.owns_node(best_id):
            tf, reg = compute_transform(
                self.nodes[best_id].frame, node.frame, None, self.camera,
                nndr=self.matching_cfg.nndr,
                min_inliers=self.pnp_cfg.min_inliers,
                refine_iterations=self.pnp_cfg.refine_iterations,
                seed=node.id, device=self.device,
                draws=None if self.draws_fn is None
                else self.draws_fn(node.id))
            if tf is not None:
                payload[0] = 1.0
                payload[1:17] = T.inverse(tf).reshape(-1)
                payload[17:] = np.linalg.inv(reg.covariance).reshape(-1)
        gathered = _comm_f64(self.comm, payload)
        owner = best_id % self.world
        payload = gathered[min(owner, len(gathered) - 1)]
        if payload[0] < 0.5:
            return None
        tf = payload[1:17].reshape(4, 4)
        information = payload[17:].reshape(6, 6)
        self.loop_closures.append((node.id, best_id))
        return Link(node.id, best_id, LOOP_CLOSURE, tf, information)

    def memory_used(self) -> dict[str, int]:
        return {"Mapper.nodes": self.owned_feature_bytes(),
                "Mapper.words": self.vwd.owned_bytes(),
                "Mapper.index": self.vwd._train.nbytes}
