"""tpuslam_torch's pose-graph device back end (optim/device.py) against
tpuslam's (JAX on the CPU).

The graph is tests/test_optim.py's make_noisy_loop at 40 vertices (its
backward loop closure 40 -> 1) plus one forward loop closure 5 -> 30 at
its true relative pose, which classify_extra_edges puts in the Woodbury
extras (R = 1).  Inputs are made with numpy from a seed and fed to both
packages; tpuslam runs its own jitted functions.  Tolerances, each with
its reason:
- the linearisations: 1e-5 of each output's largest magnitude (f32, the
  per-edge products and the scatter-adds sum in another order);
- the block-Thomas and Woodbury solves: 1e-4 of max|X| (f32 through a
  system of condition ~1e5: each solver's own f32 error is ~5e-5);
- the solvers after 5 LM iterations, run_optimize and the robust loop:
  chi2 rtol 2e-3 and translations atol 2e-2, the JAX suite's own
  device-vs-device tolerance (tests/test_dist.py:108-111);
- the port's device back end against its own f64 host back end: atol
  5e-2 and chi2 within 10 % (tests/test_dist.py:124-125).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tpuslam.mapping.graph import Link, LOOP_CLOSURE
from tpuslam.optim import device as J
from tpuslam_torch import convert
from tpuslam_torch.optim import device as T

from test_optim import make_noisy_loop


ITERS = 5


def _graph(outlier=False):
    """make_noisy_loop(40) with a forward loop closure 5 -> 30 (tpuslam's
    classes), and with `outlier` a gross loop closure 30 -> 5 as
    tests/test_dist.py's robust test adds."""
    gt, poses, links = make_noisy_loop(np.random.default_rng(9), n=40)
    fwd = (np.linalg.inv(gt[4]) @ gt[29]).astype(np.float32)
    links.insert(5, Link(5, 30, LOOP_CLOSURE, fwd, np.eye(6) * 100.0))
    if outlier:
        bad = np.eye(4, dtype=np.float32)
        bad[:3, 3] = [25.0, -13.0, 8.0]
        links.insert(30, Link(30, 5, LOOP_CLOSURE, bad, np.eye(6) * 100.0))
    return poses, links


@pytest.fixture(scope="module")
def g():
    """The graph's arrays, as jnp (tpuslam) and torch (the port, CPU)."""
    poses, links = _graph()
    ids, P, ef, et, Z, O, fidx = J.graph_to_arrays(poses, links)
    xsel, xp, xq = J.classify_extra_edges(ef, et, fidx)
    assert len(xp) == 1
    nf = len(ids) - 1
    arrs = dict(P=P, ef=ef, et=et, Z=Z, O=O, fidx=fidx, xsel=xsel, xp=xp,
                xq=xq)
    jx = {k: jnp.asarray(v) for k, v in arrs.items()}
    tt = {k: torch.as_tensor(v, dtype=torch.float32 if v.dtype.kind == "f"
                             else torch.long) for k, v in arrs.items()}
    jx["Zi"], tt["Zi"] = J._se3_inv(jx["Z"]), T._se3_inv(tt["Z"])
    return dict(nf=nf, j=jx, t=tt, poses=poses, links=links)


def _args(s, nf, fn):
    head = (s["P"], s["ef"], s["et"], s["Zi"], s["Z"], s["O"], nf, s["fidx"])
    if fn == "sparse_system":
        return head + (s["xsel"], s["xp"], s["xq"], nf - 1)
    return head


@pytest.fixture(scope="module")
def systems(g):
    """sparse_system of both packages: (tpuslam's as numpy, the port's)."""
    ref = [np.asarray(a) for a in J.sparse_system(
        *_args(g["j"], g["nf"], "sparse_system"))]
    got = T.sparse_system(*_args(g["t"], g["nf"], "sparse_system"))
    return ref, got


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= rtol, err


@pytest.mark.parametrize("fn", ["lm_system", "sparse_system",
                                "gn_normal_equations"])
def test_linearisation_matches_reference(g, systems, fn):
    """Each output within 1e-5 of its largest magnitude: f32 sums in
    another order."""
    if fn == "sparse_system":
        ref, got = systems
    else:
        ref = getattr(J, fn)(*_args(g["j"], g["nf"], fn))
        got = getattr(T, fn)(*_args(g["t"], g["nf"], fn))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _close(a, b, 1e-5)


def _rhs(g, systems, R):
    """The solve's right-hand side: b alone (R = 0), or b beside the
    Woodbury block-columns P of the one extra (R = 1)."""
    D, S, X, b, _, max_diag = systems[0]
    n = D.shape[0]
    lam = np.float32(1e-5) * max_diag
    B = b.reshape(n, 6, 1)
    if R:
        xp, xq = int(g["j"]["xp"][0]), int(g["j"]["xq"][0])
        P = np.zeros((n, 6, 12), np.float32)
        P[xp, :, 0:6] = np.eye(6)
        P[xq, :, 6:12] = np.eye(6)
        B = np.concatenate([B, P], axis=-1)
    return D, S, X, b, lam, B


@pytest.mark.parametrize("R", [0, 1])
def test_thomas_solve_matches_reference(g, systems, R):
    """The plain block-Thomas solve (K7's plain version) on the graph's
    own D, S at the LM's first lambda, 1 + 12R columns: 1e-4 of max|X|."""
    D, S, _, _, lam, B = _rhs(g, systems, R)
    ref = J._thomas_solve(jnp.asarray(D), jnp.asarray(S), jnp.asarray(B),
                          jnp.float32(lam))
    got = T._thomas_solve(torch.tensor(D), torch.tensor(S), torch.tensor(B),
                          torch.tensor(lam))
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("R", [0, 1])
def test_sparse_solve_matches_reference(g, systems, R):
    """The Woodbury solve without (R = 0) and with the graph's extra
    block (R = 1): 1e-4 of max|x|."""
    D, S, X, b, lam, _ = _rhs(g, systems, R)
    xp, xq = (g["j"]["xp"], g["j"]["xq"]) if R else \
        (jnp.zeros(0, jnp.int32), jnp.zeros(0, jnp.int32))
    X = X[:R]
    ref = J._sparse_solve(jnp.asarray(D), jnp.asarray(S), jnp.asarray(X),
                          xp, xq, jnp.asarray(b), jnp.float32(lam))
    got = T._sparse_solve(*(torch.tensor(a) for a in (D, S, X)),
                          torch.tensor(np.asarray(xp), dtype=torch.long),
                          torch.tensor(np.asarray(xq), dtype=torch.long),
                          torch.tensor(b), torch.tensor(lam))
    _close(got, ref, 1e-4)


def _solve(pkg, s, nf, fn):
    head = (s["P"], s["ef"], s["et"], s["Z"], s["O"], s["fidx"], nf)
    if fn == "lm_solve_sparse":
        head += (s["xsel"], s["xp"], s["xq"])
    if pkg is J and fn == "gn_solve":
        # tpuslam's jit leaves n_free traced; the same function with it
        # static
        f = jax.jit(J.gn_solve.__wrapped__,
                    static_argnames=("iterations", "n_free"))
        return f(*head, iterations=ITERS)
    return getattr(pkg, fn)(*head, iterations=ITERS)


def _translations(poses):
    return np.asarray(poses)[:, :3, 3]


@pytest.mark.parametrize("fn", ["lm_solve", "lm_solve_sparse", "gn_solve"])
def test_solver_matches_reference(g, fn):
    """5 iterations: the chi2 of every iteration rtol 2e-3, the poses'
    translations atol 2e-2 (tests/test_dist.py:108-111)."""
    pj, cj = _solve(J, g["j"], g["nf"], fn)
    pt, ct = _solve(T, g["t"], g["nf"], fn)
    assert ct.shape == (ITERS,)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=2e-3)
    np.testing.assert_allclose(_translations(pt.numpy()), _translations(pj),
                               rtol=0, atol=2e-2)
    if fn != "gn_solve":                 # gn_solve returns chi2 before
        assert float(ct[-1]) < 0.2 * float(ct[0])


def _pose_close(got, ref, atol):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k][:3, 3], ref[k][:3, 3], rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("backend", ["device", "device-dense"])
def test_run_optimize_matches_reference(g, backend):
    """run_optimize dispatches as tpuslam's ("device": lm_solve_sparse,
    "device-dense": lm_solve): poses as f32 numpy, chi2 the last
    iteration's, to the solvers' tolerance."""
    from tpuslam.optim import pose_graph as JPG
    from tpuslam_torch.optim import run_optimize
    ref, ref_chi2 = JPG.run_optimize(g["poses"], g["links"], ITERS,
                                     backend=backend)
    tp, tl = convert.graph_from_reference(g["poses"], g["links"])
    got, chi2 = run_optimize(tp, tl, ITERS, backend=backend, device="cpu")
    assert all(v.dtype == np.float32 for v in got.values())
    _pose_close(got, ref, 2e-2)
    assert abs(chi2 - ref_chi2) <= 2e-3 * ref_chi2


def _links_per_round(monkeypatch, module):
    """Record the link set (from, to) that each robust round starts
    from."""
    rounds, orig = [], module.get_connected_graph

    def rec(root, poses, links):
        rounds.append(sorted((l.from_id, l.to_id) for l in links.values()))
        return orig(root, poses, links)
    monkeypatch.setattr(module, "get_connected_graph", rec)
    return rounds


def test_robust_device_matches_reference(monkeypatch):
    """run_optimize_robust(backend="device") ejects the same edge, the
    gross closure 30 -> 5, in the same rounds as tpuslam's and ends within
    the solvers' tolerance of it."""
    from tpuslam.optim import pose_graph as JPG
    from tpuslam_torch.optim import pose_graph as TPG
    poses, links = _graph(outlier=True)
    jr = _links_per_round(monkeypatch, JPG)
    tr = _links_per_round(monkeypatch, TPG)
    ref, ref_chi2 = JPG.run_optimize_robust(poses, links, 20,
                                            backend="device")
    tp, tl = convert.graph_from_reference(poses, links)
    got, chi2 = TPG.run_optimize_robust(tp, tl, 20, backend="device",
                                        device="cpu")
    assert tr == jr and len(tr) == 2
    assert (30, 5) in tr[0] and (30, 5) not in tr[1]
    _pose_close(got, ref, 2e-2)
    assert abs(chi2 - ref_chi2) <= 2e-3 * ref_chi2


@pytest.mark.parametrize("backend", ["device", "device-dense"])
def test_robust_rounds_follow_tpuslam(monkeypatch, backend):
    """Inside run_optimize_robust only "device" solves the ejection rounds
    on the device; "device-dense" solves them on the host and only its
    final run_optimize on the device (tpuslam/optim/pose_graph.py:
    424-430), with the same result as tpuslam's ("device"'s result:
    test_robust_device_matches_reference)."""
    from tpuslam.optim import pose_graph as JPG
    from tpuslam_torch.optim import pose_graph as TPG
    poses, links = _graph(outlier=True)
    calls, orig = [], TPG._run_optimize_device

    def rec(poses, links, num, cfg, dense=False, device="cuda"):
        calls.append((num, dense, device))
        return orig(poses, links, num, cfg, dense=dense, device=device)
    monkeypatch.setattr(TPG, "_run_optimize_device", rec)
    tp, tl = convert.graph_from_reference(poses, links)
    got, chi2 = TPG.run_optimize_robust(tp, tl, 20, backend=backend,
                                        device="cpu")
    if backend == "device":
        assert calls == [(5, False, "cpu"), (5, False, "cpu"),
                         (20, False, "cpu")]
        return
    assert calls == [(20, True, "cpu")]
    ref, ref_chi2 = JPG.run_optimize_robust(poses, links, 20,
                                            backend=backend)
    _pose_close(got, ref, 2e-2)
    assert abs(chi2 - ref_chi2) <= 2e-3 * ref_chi2


def test_device_backend_against_host(g):
    """The port's device back end (f32) against its own host back end
    (f64) after 10 iterations: translations atol 5e-2, chi2 within 10 %
    (tests/test_dist.py:124-125)."""
    from tpuslam_torch.optim import run_optimize
    tp, tl = convert.graph_from_reference(g["poses"], g["links"])
    host, host_chi2 = run_optimize(tp, tl, 10)
    dev, dev_chi2 = run_optimize(tp, tl, 10, backend="device", device="cpu")
    _pose_close(dev, host, 5e-2)
    assert abs(dev_chi2 - host_chi2) / (host_chi2 + 1e-9) < 0.1


def test_degenerate_graphs_return_the_input():
    """No edge, or no free vertex: the input poses as f32 and chi2 0.0,
    as tpuslam's; one free vertex takes the dense solve."""
    from tpuslam_torch.mapping.graph import Link as TLink, MultiMap, NEIGHBOR
    from tpuslam_torch.optim import run_optimize
    p = {1: np.eye(4), 2: np.eye(4) + 0.5 * np.eye(4, k=3)}
    out, chi2 = run_optimize(p, MultiMap(), 5, backend="device",
                             device="cpu")
    assert chi2 == 0.0 and out[2].dtype == np.float32
    np.testing.assert_array_equal(out[2], p[2])
    links = MultiMap()
    meas = np.eye(4, dtype=np.float32)
    meas[0, 3] = 1.0
    links.insert(1, TLink(1, 2, NEIGHBOR, meas, np.eye(6) * 100.0))
    out, chi2 = run_optimize({1: p[1]}, links, 5, backend="device",
                             device="cpu")
    assert chi2 == 0.0
    out, chi2 = run_optimize(p, links, 5, backend="device", device="cpu")
    np.testing.assert_allclose(out[2][:3, 3], [1.0, 0.0, 0.0], atol=1e-4)
    assert chi2 < 1e-6


def test_k7_max_cols_is_the_kernels():
    """The wrapper sizes K7's factor chains (one per thread block) by
    K7_MAX_COLS: it must be csrc/thomas.cu's MAX_COLS, or the blocks
    past the first would write beyond L."""
    import re
    from pathlib import Path
    src = (Path(T.__file__).parents[1] / "csrc" / "thomas.cu").read_text()
    warps = re.search(r"constexpr int MAX_WARPS = (\d+);", src)
    assert re.search(r"constexpr int MAX_COLS = 32 \* \(MAX_WARPS - 2\);",
                     src)
    assert T.K7_MAX_COLS == 32 * (int(warps.group(1)) - 2)
