"""Descriptor matching helpers.

Counterpart of tpuslam/kernels/matching.py.  The Hamming matrix of
256-bit descriptors is `na + nb - 2 a.b^T` over {0,1} vectors: one f32
matmul, exact because every partial sum is an integer below 2^24.  The
brute-force and guided KNN-2 matchers (registration's matchingNoGuess and
matchingGuess) run on the descriptors' device; the NNDR test and the
first-wins dedup are host numpy, as in tpuslam.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e9


def unpack_bits(desc_u8: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 256) float32 in {0,1}, LSB first per byte
    (the ORB kernel's packing)."""
    shifts = torch.arange(8, device=desc_u8.device, dtype=torch.uint8)
    bits = (desc_u8[..., None] >> shifts) & 1
    return bits.reshape(*desc_u8.shape[:-1], -1).float()


def _top2_min(dist: torch.Tensor):
    """Per-row two smallest (values, indices) of (..., rows, n); ties go
    to the lower index (BFMatcher's sequential strict-less scan)."""
    n = dist.shape[-1]
    cols = torch.arange(n, device=dist.device)
    d1 = dist.amin(dim=-1)
    i1 = torch.where(dist == d1[..., None], cols, n).amin(dim=-1)
    i1 = torch.clamp(i1, max=n - 1)
    masked = torch.where(cols == i1[..., None], BIG, dist)
    d2 = masked.amin(dim=-1)
    i2 = torch.where(masked == d2[..., None], cols, n).amin(dim=-1)
    i2 = torch.clamp(i2, max=n - 1)
    return d1, i1, d2, i2


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor):
    """(Na, 32) x (Nb, 32) uint8 -> (Na, Nb) float32 Hamming distances."""
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    na = a.sum(dim=1, keepdim=True)
    nb = b.sum(dim=1, keepdim=True)
    return na + nb.T - 2.0 * (a @ b.T)


def knn2_hamming(desc_a, valid_a, desc_b, valid_b):
    """Brute-force KNN k=2 from A (query) into B (train), Hamming
    (matchingNoGuess, Registration.cpp:311-335).  Returns (d1, i1, d2, i2)
    per query row; invalid rows and columns give BIG."""
    dist = hamming_matrix(desc_a, desc_b)
    dist = torch.where(valid_b[None, :], dist, BIG)
    dist = torch.where(valid_a[:, None], dist, BIG)
    return _top2_min(dist)


def guided_knn2_hamming(desc_a, proj_xy, proj_valid, desc_b, kpts_b,
                        valid_b, radius):
    """Per projected 'from' point, KNN-2 Hamming restricted to the 'to'
    keypoints within `radius` px of the projection (matchingGuess,
    Registration.cpp:236-303).  Returns (d1, i1, d2, i2, n_candidates)."""
    dx = proj_xy[:, 0:1] - kpts_b[None, :, 0]
    dy = proj_xy[:, 1:2] - kpts_b[None, :, 1]
    in_radius = (dx * dx + dy * dy <= radius * radius) & \
        valid_b[None, :] & proj_valid[:, None]
    n_cand = in_radius.sum(dim=1)
    dist = torch.where(in_radius, hamming_matrix(desc_a, desc_b), BIG)
    d1, i1, d2, i2 = _top2_min(dist)
    return d1, i1, d2, i2, n_cand


def nndr_accept(d1, i1, d2, n_cand, nndr: float = 0.8,
                single_accept: bool = True):
    """NNDR uniqueness test (host, numpy): with >= 2 candidates accept iff
    d1 < nndr * d2 (strict); with exactly 1 accept unconditionally on the
    guided path (Registration.cpp:215-218).  Returns the accept mask."""
    d1, d2 = np.asarray(d1), np.asarray(d2)
    n_cand = np.asarray(n_cand)
    ok = (n_cand >= 2) & (d1 < nndr * d2)
    if single_accept:
        ok |= (n_cand == 1)
    return ok


def dedup_matches(from_idx, to_idx, accept):
    """Ordered first-wins dedup on the train index (the reference's
    addedIndex set, Registration.cpp:284-300).  Returns (from, to) pairs."""
    seen = set()
    out = []
    for f, t, a in zip(from_idx, to_idx, accept):
        if not a:
            continue
        t = int(t)
        if t in seen:
            continue
        seen.add(t)
        out.append((int(f), t))
    return out
