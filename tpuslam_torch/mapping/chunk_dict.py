"""Per-chunk device dictionary update, in PyTorch.

Counterpart of tpuslam/mapping/chunk_dict.py.  The dictionary work of all
of a chunk's full nodes is queued on the device right after the VO chunk,
on the VO's still-on-device features, with no host synchronisation: the
device runs VO_i -> dict_i -> VO_{i+1} back to back.  The host fetches the
per-node decisions (keep mask, uniqueness, match rows, count after) when
it unpacks the chunk and replays the exact VWDictionary bookkeeping
(mapping/dictionary.py apply_precomputed).

Semantics (bit-equal to the incremental dictionary, held by the
count_after invariant in Mapper._add_word_ids and by
tests/test_torch_mapping.py):
  * per-node keypoint cap: top max_features by (|response|, larger
    index), SensorData::limitKeypoints (vo/frame.py limit_keypoints);
  * each node's batch searches the dictionary state before the batch;
  * uniqueness: < 2 words, or d1 > nndr * d2 (f32, strict);
  * insertion order, hence word ids, identical.

The nodes of a chunk run one after another on the device (a Python loop,
tpuslam's lax.scan); the word matrix is one buffer updated in place (JAX
donates it) and grown by doubling on the host's worst-case bound.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..runtime import perf

BIG = 1e30


def _node_update(train, count, desc_u8, resp, nk, active, qcap: int,
                 nndr: torch.Tensor, max_features: int):
    """One full node: limit_keypoints, compact, top-2 against rows <
    count, uniqueness, append the unique rows at `count` (in place).
    Returns (count', keep, unique, i1, ok); every value a device tensor."""
    cap = train.shape[0]
    C = desc_u8.shape[0]
    dev = train.device
    n = torch.clamp(nk, max=C)
    ar_c = torch.arange(C, device=dev)
    valid = ar_c < n

    # limit_keypoints: top max_features by (|r|, larger index); a stable
    # sort of the reversed array breaks ties toward the larger index
    a = torch.where(valid, resp.abs(), -1.0)
    pos = torch.argsort(-a.flip(0), stable=True)
    order = (C - 1) - pos
    kmax = torch.clamp(n, max=max_features)
    keep = torch.zeros((C,), dtype=torch.bool, device=dev)
    keep[order[:max_features]] = \
        torch.arange(max_features, device=dev) < kmax

    # compact the kept rows (row order) to the query pad
    cidx = torch.argsort((~keep).to(torch.uint8), stable=True)[:qcap]
    q = desc_u8[cidx].float()                              # (qcap, 32)
    kvalid = torch.arange(qcap, device=dev) < keep.sum()

    # top-2 squared L2 against the rows < count (dictionary.py twin)
    cols = torch.arange(cap, device=dev)
    qq = torch.sum(q * q, dim=1, keepdim=True)
    tt = torch.sum(train * train, dim=1)
    d = qq + tt[None, :] - 2.0 * (q @ train.T)
    d = torch.clamp(torch.where(cols < count, d, BIG), min=0.0)
    d1 = d.amin(dim=1)
    i1 = torch.clamp(torch.where(d == d1[:, None], cols, cap).amin(dim=1),
                     max=cap - 1)
    d2 = torch.where(cols == i1[:, None], BIG, d).amin(dim=1)

    unique = kvalid & torch.where(count >= 2, d1 > nndr * d2, True) & active
    ok = count + qcap <= cap
    unique = unique & ok
    n_new = unique.sum()

    # append the unique rows (k-order) as one contiguous block at count;
    # rows of the block beyond n_new land beyond the new count and are
    # overwritten by the next append before any search can see them.
    # When the capacity check fails the rows are rewritten unchanged.
    block = q[torch.argsort((~unique).to(torch.uint8), stable=True)]
    rows = torch.where(ok, count, 0) + torch.arange(qcap, device=dev)
    train.index_copy_(0, rows, torch.where(ok, block, train[rows]))
    count = count + n_new
    return count, keep & active, unique, i1, ok


class ChunkDictDriver:
    """Owns the device word matrix and queues each chunk's update.

    dispatch() must be called once per chunk, in order, right after the
    VO chunk, with the VO's device feature tensors; fetch() returns the
    per-node host decisions.  Word-id bookkeeping is replayed by
    VWDictionary.apply_precomputed.
    """
    MIN_CAPACITY = 32768

    def __init__(self, nndr: float, max_features: int, qcap: int = 768,
                 device="cuda"):
        self.nndr = float(nndr)
        self.max_features = int(max_features)
        # the device program truncates kept rows at qcap while the host
        # keep mask selects up to max_features: qcap must cover it
        self.qcap = max(int(qcap), int(max_features))
        self.device = torch.device(device)
        self.capacity = self.MIN_CAPACITY
        self.train = torch.zeros((self.capacity, 32), dtype=torch.float32,
                                 device=self.device)
        self.count = torch.tensor(0, device=self.device)
        self._nndr_t = torch.tensor(self.nndr, dtype=torch.float32,
                                    device=self.device)
        # host upper bound on the device count: last fetched exact count
        # plus worst-case growth of the chunks still in flight (dispatch
        # runs on the producer thread, fetch on the consumer)
        self._lock = threading.Lock()
        self._base = 0                  # exact count at last fetch
        self._inflight_nodes = 0

    def seed(self, vwd) -> None:
        """Adopt the rows of an existing (host) VWDictionary."""
        need = vwd._count + self.qcap
        while self.capacity < need:
            self.capacity *= 2
        buf = np.zeros((self.capacity, 32), np.float32)
        buf[:vwd._count] = vwd._train[:vwd._count]
        self.train = torch.as_tensor(buf, device=self.device).clone()
        self.count = torch.tensor(vwd._count, device=self.device)
        self._base = vwd._count

    def _ensure_capacity(self, n_nodes: int) -> None:
        with self._lock:
            self._inflight_nodes += n_nodes
            need = self._base + self._inflight_nodes * self.qcap
        if need <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        pad = torch.zeros((new_cap - self.capacity, 32), dtype=torch.float32,
                          device=self.device)
        self.train = torch.cat([self.train, pad], dim=0)
        self.capacity = new_cap

    def dispatch(self, descs, resps, n_kpts, node_active) -> dict:
        """descs (K, C, 32) u8 / resps (K, C) f32 / n_kpts (K,) device
        tensors (the VO chunk's outputs); node_active (K,) host bools.
        Queues the update and the copies of its decisions to the host;
        returns the handle for fetch()."""
        with perf.span("dict.dispatch"):
            K = int(descs.shape[0])
            self._ensure_capacity(K)   # worst case uses qcap even if C < qcap
            C = int(descs.shape[1])
            qcap = min(self.qcap, C)
            mf = min(self.max_features, C)
            outs = {k: [] for k in ("keep", "unique", "i1", "count_after",
                                    "ok")}
            for j in range(K):
                active = torch.tensor(bool(node_active[j]), device=self.device)
                self.count, keep, unique, i1, ok = _node_update(
                    self.train, self.count, descs[j], resps[j], n_kpts[j],
                    active, qcap, self._nndr_t, mf)
                for k, v in zip(outs, (keep, unique, i1, self.count, ok)):
                    outs[k].append(v)
            perf.count("dict.nodes", K)
            host = {k: torch.stack(v).to("cpu", non_blocking=True)
                    for k, v in outs.items()}
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            return dict(host=host, event=event, k=K)

    def fetch(self, handle: dict) -> dict:
        with perf.span("dict.fetch"):
            if handle["event"] is not None:
                handle["event"].synchronize()
            out = {k: v.numpy() for k, v in handle["host"].items()}
            if not bool(np.all(out["ok"])):
                raise RuntimeError("chunk dictionary capacity exceeded")
            with self._lock:
                # the exact count replaces this chunk's worst-case share
                # (fetches happen in dispatch order)
                self._base = int(out["count_after"][-1])
                self._inflight_nodes -= handle["k"]
            return out
