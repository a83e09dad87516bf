"""The assembly's segment sums (tpuslam_torch/optim/segment.py) on the
CPU: bit for bit the `index_add_` calls that assembled the pose graph's
and bundle adjustment's normal equations before, on their own inputs
(repeated destinations, masked edges that land on a dump row, BA's
padded observations all on camera 0 and landmark 0), and each
destination's terms added in edge order.  Bit for bit, since the sums are
taken in one order: tolerance 0.  On the card the same sums are held to
these CPU ones in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from tpuslam_torch.optim import ba as BA
from tpuslam_torch.optim import device as T
from tpuslam_torch.optim.segment import segment_sum

from test_optim import make_noisy_loop
from tpuslam.mapping.graph import Link, LOOP_CLOSURE


def _equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a, b)
    # and the signs of zeros
    assert torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.mark.parametrize("case", ["unique", "repeated", "one_destination",
                                  "empty_destinations", "rows"])
def test_segment_sum_adds_in_edge_order(case):
    """Each destination's terms added one at a time in edge order from
    zero: a float32 loop in numpy gives the same bits."""
    rng = np.random.default_rng(3)
    e, n = 200, 17
    idx = {"unique": rng.permutation(n)[:n],
           "repeated": rng.integers(0, n, e),
           "one_destination": np.zeros(e, np.int64),
           "empty_destinations": rng.integers(3, 6, e),
           "rows": rng.integers(0, n, e)}[case]
    shape = (len(idx), 6, 6) if case == "rows" else (len(idx), 6)
    x = (rng.normal(0, 1, shape) * 10.0 ** rng.integers(-6, 6, shape)) \
        .astype(np.float32)
    want = np.zeros((n,) + shape[1:], np.float32)
    for k, d in enumerate(idx):
        want[d] = want[d] + x[k]
    got = segment_sum(torch.as_tensor(x), torch.as_tensor(idx), n)
    _equal(got, torch.as_tensor(want))
    _equal(got, torch.zeros((n,) + shape[1:]).index_add_(
        0, torch.as_tensor(idx), torch.as_tensor(x)))


def _graph():
    """make_noisy_loop(40) with a forward loop closure 5 -> 30 (an extra
    block) and a second edge between 10 and 11 (a repeated sub-diagonal
    block); the fixed vertex 1's edges are masked onto the dump row."""
    gt, poses, links = make_noisy_loop(np.random.default_rng(9), n=40)
    fwd = (np.linalg.inv(gt[4]) @ gt[29]).astype(np.float32)
    links.insert(5, Link(5, 30, LOOP_CLOSURE, fwd, np.eye(6) * 100.0))
    rel = (np.linalg.inv(gt[9]) @ gt[10]).astype(np.float32)
    links.insert(10, Link(10, 11, LOOP_CLOSURE, rel, np.eye(6) * 50.0))
    ids, P, ef, et, Z, O, fidx = T.graph_to_arrays(poses, links)
    xsel, xp, xq = T.classify_extra_edges(ef, et, fidx)
    t = {k: torch.as_tensor(v, dtype=torch.float32 if v.dtype.kind == "f"
                            else torch.long)
         for k, v in dict(P=P, ef=ef, et=et, Z=Z, O=O, fidx=fidx,
                          xsel=xsel, xp=xp, xq=xq).items()}
    t["Zi"] = T._se3_inv(t["Z"])
    return len(ids) - 1, t


def _old_gradient(fi, fj, mi, mj, bi, bj, n_free):
    size = n_free * 6
    six = torch.arange(6)
    b_pad = torch.zeros((size + 6,))
    b_pad.index_add_(0, (torch.where(mi, fi, n_free)[:, None] * 6 +
                         six[None, :]).reshape(-1), bi.reshape(-1))
    b_pad.index_add_(0, (torch.where(mj, fj, n_free)[:, None] * 6 +
                         six[None, :]).reshape(-1), bj.reshape(-1))
    return b_pad[:size]


def _old_blocks(parts, n_free):
    size = n_free * 6
    A_pad = torch.zeros((size + 6, size + 6))
    six = torch.arange(6)
    for fi, fj, blocks, mask in parts:
        rows = torch.where(mask, fi, n_free)[:, None] * 6 + six[None, :]
        cols = torch.where(mask, fj, n_free)[:, None] * 6 + six[None, :]
        flat = rows[:, :, None] * (size + 6) + cols[:, None, :]
        A_pad.view(-1).index_add_(0, flat.reshape(-1), blocks.reshape(-1))
    return A_pad[:size, :size]


@pytest.mark.parametrize("fn", ["lm_system", "gn_normal_equations",
                                "sparse_system"])
def test_assembly_equals_index_add(fn):
    """The three linearisations equal the index_add_ assembly they
    replaced, bit for bit."""
    nf, s = _graph()
    _, bi, bj, m_ii, m_jj, m_ij, _ = T._edge_terms(
        s["P"], s["ef"], s["et"], s["Zi"], s["Z"], s["O"])
    fi, fj = s["fidx"][s["ef"]], s["fidx"][s["et"]]
    mi, mj = fi >= 0, fj >= 0
    assert not bool(mi.all() and mj.all())          # masked edges present
    head = (s["P"], s["ef"], s["et"], s["Zi"], s["Z"], s["O"], nf, s["fidx"])
    b_old = _old_gradient(fi, fj, mi, mj, bi, bj, nf)
    if fn == "lm_system":
        A, b, _, _ = T.lm_system(*head)
        _equal(A, _old_blocks([(fi, fi, m_ii.transpose(1, 2), mi),
                               (fj, fj, m_jj.transpose(1, 2), mj),
                               (fj, fi, m_ij.transpose(1, 2), mi & mj)], nf))
    elif fn == "gn_normal_equations":
        A, b, _ = T.gn_normal_equations(*head)
        _equal(A, _old_blocks([(fi, fi, m_ii, mi), (fj, fj, m_jj, mj),
                               (fi, fj, m_ij, mi & mj),
                               (fj, fi, m_ij.transpose(1, 2), mi & mj)], nf))
    else:
        D, S, X, b, _, _ = T.sparse_system(
            *head, s["xsel"], s["xp"], s["xq"], nf - 1)
        assert X.shape[0] == 1
        eye6 = torch.eye(6)

        def tril_sym(B):
            L = torch.tril(B)
            return L + L.transpose(-1, -2) - B * eye6
        D_old = torch.zeros((nf + 1, 6, 6))
        D_old.index_add_(0, torch.where(mi, fi, nf),
                         tril_sym(m_ii.transpose(1, 2)))
        D_old.index_add_(0, torch.where(mj, fj, nf),
                         tril_sym(m_jj.transpose(1, 2)))
        keep = mi & mj & (fj > fi)
        sub = keep & (fj == fi + 1)
        S_old = torch.zeros((nf, 6, 6)).index_add_(
            0, torch.where(sub, fi, nf - 1), m_ij.transpose(1, 2))
        X_old = torch.zeros((2, 6, 6)).index_add_(
            0, torch.where(keep & (s["xsel"] >= 0), s["xsel"], 1),
            m_ij.transpose(1, 2))
        _equal(D, D_old[:nf])
        _equal(S, S_old[:nf - 1])
        _equal(X, X_old[:1])
    _equal(b, b_old)


def _ba_problem(pad):
    """6 cameras, 80 landmarks, every landmark seen by 3-6 cameras, and
    `pad` padded observations (camera 0, landmark 0, not valid), as
    mapping/ba_window.py's fixed capacity leaves them."""
    rng = np.random.default_rng(4)
    W, L = 6, 80
    Tcw = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    Tcw[:, 0, 3] = -0.5 * np.arange(W)
    lms = np.stack([rng.uniform(-4, 4, L), rng.uniform(-2, 2, L),
                    rng.uniform(6, 20, L)], 1).astype(np.float32)
    oc, ol = [], []
    for j in range(L):
        for c in rng.choice(W, rng.integers(3, 7), replace=False):
            oc.append(c)
            ol.append(j)
    oc = np.asarray(oc + [0] * pad, np.int64)
    ol = np.asarray(ol + [0] * pad, np.int64)
    valid = np.arange(len(oc)) < len(oc) - pad
    intr = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    uv = rng.uniform(0, 600, (len(oc), 2)).astype(np.float32)
    uv[~valid] = 0.0
    return [torch.as_tensor(a) for a in (Tcw, lms, intr, oc, ol, uv,
                                         valid)], W, L


@pytest.mark.parametrize("pad", [0, 300])
def test_ba_normal_equations_equal_index_add(monkeypatch, pad):
    """BA's five segment sums equal zeros().index_add_ bit for bit, with
    and without the padded observations."""
    args, W, L = _ba_problem(pad)
    got = BA.ba_normal_equations(*args, W, L, huber_delta=8.0)
    monkeypatch.setattr(BA, "_segment_sum", lambda x, idx, n: torch.zeros(
        (n,) + x.shape[1:], dtype=x.dtype).index_add_(0, idx, x))
    want = BA.ba_normal_equations(*args, W, L, huber_delta=8.0)
    for a, b in zip(got, want):
        _equal(a, b)
