"""Incremental visual-word dictionary, in PyTorch.

Counterpart of tpuslam/mapping/dictionary.py (the reference's
VWDictionary.cpp + VisualWord.cpp): an exact brute-force squared-L2 top-2
over the 32 byte values of each descriptor, |a|^2 + |b|^2 - 2 a.b^T as one
matmul.  Descriptor bytes are integers <= 255 held as f32, so every term
is an integer below 2^24 and the matmul is exact in f32 (TF32 stays off,
tpuslam_torch/__init__.py): the decisions are bit-equal to tpuslam's.

Semantics (VWDictionary.cpp:40-115): the whole batch is searched against
the dictionary state before the batch; a descriptor is a new word when
fewer than 2 words exist or d1 > nndr * d2 (f32, strict), else it adds a
reference to its nearest word; word ids start at 0.  The device copy of
the word matrix lives on `device` and grows in power-of-two steps.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e30


def _l2_top2(query: torch.Tensor, train: torch.Tensor, valid: torch.Tensor):
    """(Q, 32) x (W, 32) float32 -> per-query two smallest squared L2
    (d1, i1, d2); invalid train rows excluded; ties to the lower row."""
    d = _l2_dist(query, train, valid)
    d1, i1, dm = _first_min(d)
    return d1, i1, dm.amin(dim=1)


def _l2_dist(query, train, valid):
    qq = torch.sum(query * query, dim=1, keepdim=True)
    tt = torch.sum(train * train, dim=1)
    d = qq + tt[None, :] - 2.0 * (query @ train.T)
    return torch.clamp(torch.where(valid[None, :], d, BIG), min=0.0)


def _first_min(d):
    """Row minimum, the lowest column holding it, and d with that column
    masked to BIG."""
    nw = d.shape[1]
    cols = torch.arange(nw, device=d.device)
    d1 = d.amin(dim=1)
    i1 = torch.clamp(torch.where(d == d1[:, None], cols, nw).amin(dim=1),
                     max=nw - 1)
    return d1, i1, torch.where(cols == i1[:, None], BIG, d)


def _l2_top2_count(query, train_dev, count):
    """_l2_top2 against a resident device word matrix: rows >= count (a
    device scalar) are excluded."""
    valid = torch.arange(train_dev.shape[0], device=train_dev.device) < count
    return _l2_top2(query, train_dev, valid)


def _l2_top2_ids(query, train_dev, count):
    """_l2_top2_count that also returns the second-best row index."""
    valid = torch.arange(train_dev.shape[0], device=train_dev.device) < count
    d1, i1, dm = _first_min(_l2_dist(query, train_dev, valid))
    d2, i2, _ = _first_min(dm)
    return d1, i1, d2, i2


def _append_rows(train_dev, rows, count):
    """Write `rows` into train_dev starting at row `count`, in place."""
    train_dev[count:count + rows.shape[0]] = rows
    return train_dev


class VisualWord:
    __slots__ = ("id", "descriptor", "references", "total_references")

    def __init__(self, word_id: int, descriptor: np.ndarray, node_id: int):
        self.id = word_id
        self.descriptor = descriptor
        self.references: dict[int, int] = {}
        self.total_references = 0
        if node_id:
            self.add_ref(node_id)

    def add_ref(self, node_id: int):
        self.references[node_id] = self.references.get(node_id, 0) + 1
        self.total_references += 1


class VWDictionary:
    MIN_CAPACITY = 1024

    def __init__(self, nndr: float = 0.8, device="cuda"):
        self.nndr = nndr
        self.device = torch.device(device)
        self.words: dict[int, VisualWord] = {}
        self._last_word_id = 0
        self._capacity = self.MIN_CAPACITY
        self._train = np.zeros((self._capacity, 32), np.float32)
        self._word_ids = np.zeros((self._capacity,), np.int64)
        self._count = 0
        # persistent device mirror of _train[:_count]; re-uploaded in full
        # only when marked dirty (growth, precomputed replay)
        self._train_dev = None
        self._dev_dirty = True

    def __len__(self):
        return self._count

    def clear(self):
        self.__init__(self.nndr, self.device)

    def _grow(self, needed: int):
        while self._capacity < needed:
            self._capacity *= 2
        train = np.zeros((self._capacity, 32), np.float32)
        ids = np.zeros((self._capacity,), np.int64)
        train[:self._count] = self._train[:self._count]
        ids[:self._count] = self._word_ids[:self._count]
        self._train, self._word_ids = train, ids
        self._dev_dirty = True

    def _sync_device(self):
        if self._dev_dirty or self._train_dev is None:
            self._train_dev = torch.as_tensor(self._train,
                                              device=self.device).clone()
            self._dev_dirty = False

    def _store_row(self, wid: int, row: np.ndarray):
        """Append word `wid`'s f32 descriptor row to the host word matrix."""
        if self._count >= self._capacity:
            self._grow(self._count + 1)
        self._train[self._count] = row
        self._word_ids[self._count] = wid
        self._count += 1

    def _mirror_rows(self, old_count: int):
        """Mirror the rows stored since `old_count` to the device (a full
        re-upload only after a capacity growth)."""
        if self._count > old_count and not self._dev_dirty and \
                self._train_dev is not None:
            _append_rows(self._train_dev, torch.as_tensor(
                self._train[old_count:self._count], device=self.device),
                old_count)

    def add_new_words(self, descriptors: np.ndarray,
                      node_id: int) -> list[int]:
        """addNewWords twin: returns the word id assigned to each
        descriptor row."""
        n = len(descriptors)
        if n == 0:
            return []
        desc_f = descriptors.astype(np.float32)

        if self._count >= 2:
            self._sync_device()
            d1, i1, d2 = (t.cpu().numpy() for t in _l2_top2_count(
                torch.as_tensor(desc_f, device=self.device),
                self._train_dev, self._count))
            have2 = np.full(n, True)
        else:
            # < 2 words: any result set is "size < 2" -> always unique
            have2 = np.full(n, False)
            d1 = i1 = d2 = np.zeros(n)

        old_count = self._count
        word_ids = []
        for k in range(n):
            unique = (not have2[k]) or (d1[k] > np.float32(self.nndr) * d2[k])
            if unique:
                wid = self._last_word_id
                self._last_word_id += 1
                self.words[wid] = VisualWord(wid, descriptors[k].copy(),
                                             node_id)
                self._store_row(wid, desc_f[k])
                word_ids.append(wid)
            else:
                wid = int(self._word_ids[int(i1[k])])
                self.words[wid].add_ref(node_id)
                word_ids.append(wid)
        self._mirror_rows(old_count)
        return word_ids

    def apply_precomputed(self, descriptors: np.ndarray, node_id: int,
                          unique: np.ndarray,
                          i1_rows: np.ndarray) -> list[int]:
        """Replay add_new_words bookkeeping from device-side decisions.

        `descriptors` are the node's kept rows (row order); `unique` /
        `i1_rows` the per-row uniqueness flags and best-match row indices
        the chunk dictionary program computed against the same state
        (mapping/chunk_dict.py).  No device traffic; identical word ids,
        references and row layout to the incremental path.
        """
        n = len(descriptors)
        if n == 0:
            return []
        desc_f = descriptors.astype(np.float32)
        if self._count + n > self._capacity:
            self._grow(self._count + n)
        word_ids = []
        for k in range(n):
            if unique[k]:
                wid = self._last_word_id
                self._last_word_id += 1
                self.words[wid] = VisualWord(wid, descriptors[k].copy(),
                                             node_id)
                self._train[self._count] = desc_f[k]
                self._word_ids[self._count] = wid
                self._count += 1
                word_ids.append(wid)
            else:
                wid = int(self._word_ids[int(i1_rows[k])])
                self.words[wid].add_ref(node_id)
                word_ids.append(wid)
        # the host mirror changed behind the device copy used by the
        # standalone search path; re-upload lazily if that path is used
        self._dev_dirty = True
        return word_ids

    def get_word(self, word_id: int) -> VisualWord | None:
        return self.words.get(word_id)
