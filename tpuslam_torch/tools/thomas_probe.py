"""Kernel K7 (csrc/thomas.cu, the block-Thomas solve) on the card: its
build, its forward and backward passes timed apart, and another version
of its source timed in turns with it.

    python -m tpuslam_torch.tools.thomas_probe [--source FILE] [--turns N]
        [--sass DIR] [--shapes 4540x13 999x1 60x325]

Builds csrc/thomas.cu and, with --source, FILE (another version of it
with the same launcher `tpuslam_thomas`, e.g. a parent's from an
unpacked archive) with `-Xptxas -v` (registers, shared memory and spills
of each kernel), in parallel, into build/tpuslam_torch/thomas_probe/.
At the back end's shapes each version is held to the plain version
(`optim.device._thomas_solve`, bit for bit) and timed behind the spin of
tools/timing.py: the whole solve and, where the source has
`tpuslam_thomas_stage`, the solve cut after its forward pass; the
versions in turns (FILE, this, this, FILE), N times.  The shapes:
4540 x 13, the first LM system of chip_smoke.py's KITTI-00-sized graph
(4541 vertices, one Woodbury extra), where the plain version would take
minutes and the versions are held to each other; 999 x 1, the same
graph's first 1000 vertices; 60 x 325, a random system of the per-frame
graph's shape (a right-hand side and 27 Woodbury extras' unit columns).
With --sass the kernels' SASS (cuobjdump) is written to DIR.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..kernels import _cuda
from .timing import time_ms

# chip_smoke.py phase 14 (c)'s graph, at a size users run: KITTI odometry
# sequence 00's 4541 frames, one node per frame as the Mapper keeps them.
# A 100-frame circuit (1 m per frame) driven again and again; every 5th
# frame of a lap closes a loop to the same place a lap before (from = new,
# to = old); odometry noise as tests/test_optim.py:55-83's make_noisy_loop
# (0.05 m and 0.01 rad per axis, Omega = 100 I); one forward closure (old
# -> new, a Woodbury extra) and one gross outlier closure
KITTI00_FRAMES = 4541
BE_LAP, BE_EVERY, BE_SEED = 100, 5, 13
BE_CUT = 1000            # the cut graph's vertices
TAU = 1e-5               # OptimizerConfig().tau: lambda_0 = tau * max_diag
SHAPES = ("4540x13", "999x1", "60x325")


def kitti_size_graph(n=KITTI00_FRAMES, seed=BE_SEED):
    """The graph above, made with numpy: ground truth (n,4,4), noisy poses
    {id: 4x4 f32}, the link MultiMap, the gross outlier's (from, to)."""
    from ..io.synthetic import exact_closure, noisy_circuit
    from ..mapping.graph import LOOP_CLOSURE, Link
    gt, poses, links = noisy_circuit(n, BE_LAP, np.random.default_rng(seed))
    for i in range(BE_LAP, n, BE_EVERY):
        exact_closure(links, gt, i, i - BE_LAP)
    exact_closure(links, gt, n - 3 * BE_LAP // 2, n - BE_LAP // 2 - 1)
    bad = np.eye(4, dtype=np.float32)
    bad[:3, 3] = [25.0, -13.0, 8.0]
    outlier = (n // 2, n // 4)
    links.insert(outlier[0], Link(*outlier, LOOP_CLOSURE, bad,
                                  np.eye(6) * 100.0))
    return gt, poses, links, outlier


def first_system(poses, links, tau=TAU):
    """The first LM iteration's K7 input for a pose graph, as
    lm_solve_sparse builds it on the card: D, S, B (the right-hand side,
    then the Woodbury extras' unit P columns) and lam = tau * max_diag."""
    from ..optim import device as DEV
    ids, P, ef, et, Z, O, fidx = DEV.graph_to_arrays(poses, links)
    xsel, xp, xq = DEV.classify_extra_edges(ef, et, fidx)
    nf = len(ids) - 1

    def on(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=dt, device="cuda")
    D, S, X, b, _, max_diag = DEV.sparse_system(
        on(P), on(ef, torch.long), on(et, torch.long),
        DEV._se3_inv(on(Z)), on(Z), on(O), nf, on(fidx, torch.long),
        on(xsel, torch.long), on(xp, torch.long), on(xq, torch.long),
        nf - 1)
    lam = (tau * max_diag).reshape(())
    B = b.reshape(nf, 6, 1)
    if len(xp):
        P_ = torch.zeros((nf, 6, 2 * len(xp), 6), device="cuda")
        P_[on(np.concatenate([xp, xq]), torch.long), :,
           torch.arange(2 * len(xp), device="cuda"), :] = \
            torch.eye(6, device="cuda")
        B = torch.cat([B, P_.reshape(nf, 6, -1)], dim=-1)
    return D.contiguous(), S.contiguous(), B.contiguous(), lam


def random_system(n, m, seed=0):
    """A symmetric positive definite block-tridiagonal system (D, S, B,
    lam) made with numpy from `seed`, each diagonal block dominating its
    two neighbours (tests/test_torch_cuda.py's).  Where m = 1 + 12 R, B
    is a right-hand side beside the unit block-columns of R Woodbury
    extras at random vertices, as lm_solve_sparse gives K7."""
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 1, (n, 6, 6))
    D = A @ A.transpose(0, 2, 1) + 12 * np.eye(6)
    S = rng.normal(0, 0.5, (n - 1, 6, 6))
    B = rng.normal(0, 1, (n, 6, m))
    if m > 1 and (m - 1) % 12 == 0:
        B[..., 1:] = 0.0
        for r, v in enumerate(rng.integers(0, n, (m - 1) // 6)):
            B[v, :, 1 + 6 * r:7 + 6 * r] = np.eye(6)
    return (*[torch.as_tensor(a, dtype=torch.float32, device="cuda")
              for a in (D, S, B)], torch.tensor(0.25, device="cuda"))


def systems(shapes=SHAPES):
    """{shape: (D, S, B, lam)} of the shapes named above."""
    from ..mapping.graph import MultiMap
    out = {}
    if {"4540x13", "999x1"} & set(shapes):
        _, poses, links, _ = kitti_size_graph()
        if "4540x13" in shapes:
            out["4540x13"] = first_system(poses, links)
        if "999x1" in shapes:
            cut = {i: poses[i] for i in range(1, BE_CUT + 1)}
            out["999x1"] = first_system(cut, MultiMap(
                (k, x) for k, x in links.items()
                if x.from_id <= BE_CUT and x.to_id <= BE_CUT))
    for s in shapes:
        if s not in out:
            n, m = map(int, s.split("x"))
            out[s] = random_system(n, m, seed=n * 100 + m)
    return {s: out[s] for s in shapes}


def solver(lib, D, S, B, lam, stop=0):
    """A call of the library's K7 on (D, S, B, lam): the whole solve, or
    with `stop` 1 the solve cut after its forward pass (None where the
    library has no cut).  Returns (call, X)."""
    n, m = B.shape[0], B.shape[2]
    # scratch factors, 48 floats a vertex for a chain per 32 columns:
    # enough for any version
    L = torch.empty(((m + 31) // 32, n, 48), device="cuda")
    G, X = torch.empty_like(B), torch.empty_like(B)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (D, S, B, lam, L, G, X)]
    P, I = ctypes.c_void_p, ctypes.c_int
    if stop:
        if not hasattr(lib, "tpuslam_thomas_stage"):
            return None, X
        fn = lib.tpuslam_thomas_stage
        fn.argtypes = [P] * 7 + [I] * 3 + [P]
        args = ptrs + [n, m, stop, stream]
    else:
        fn = lib.tpuslam_thomas
        fn.argtypes = [P] * 7 + [I] * 2 + [P]
        args = ptrs + [n, m, stream]
    fn.restype = I

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"K7 launch failed: cudaError {rc}")
    return call, X


def divcheck(lib, n=1 << 24, seed=0):
    """K7's two divisions (div_fast, and div_small for the values the
    first does not take) against IEEE division on n random pairs on the
    card: mantissas uniform, exponents uniform over [-155, 100]
    (numerators: subnormals, and below them zeros; a sixteenth of them
    zeros besides) and [-40, 40] (divisors), signs random.  Returns
    (pairs, pairs within div_fast's checks, pairs there whose bits
    differ, pairs that div_small takes whose bits differ); the last two
    must be 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(lo, hi):
        m = 1.0 + torch.rand(n, device="cuda", generator=g,
                             dtype=torch.float64)
        e = torch.randint(lo, hi + 1, (n,), device="cuda", generator=g)
        sign = torch.randint(0, 2, (n,), device="cuda", generator=g) * 2 - 1
        # in f64, then rounded to f32: subnormals where they fall
        return (sign * m * torch.exp2(e.double())).float().contiguous()
    s, d = draw(-155, 100), draw(-40, 40)
    s[torch.rand(n, device="cuda", generator=g) < 1 / 16] = 0.0
    out = torch.empty(n, dtype=torch.int32, device="cuda")
    fn = lib.tpuslam_thomas_divcheck
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if fn(s.data_ptr(), d.data_ptr(), out.data_ptr(), n,
          torch.cuda.current_stream().cuda_stream) != 0:
        raise RuntimeError("divcheck launch failed")
    fast = torch.bincount(out & 3, minlength=3).tolist()
    return n, fast[1] + fast[2], fast[1], int((out >= 4).sum())


def sass(lib_path, out_path):
    """Write the library's SASS (cuobjdump -sass) to out_path."""
    cuobjdump = Path(_cuda._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump if cuobjdump.exists() else
                               "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    Path(out_path).write_text(text)
    return text


def run(source=None, turns=1, shapes=SHAPES, sass_dir=None):
    """Build, hold and time; returns the rows (one per shape and
    version)."""
    from ..optim import device as DEV
    versions = [("this", _cuda.CSRC / "thomas.cu")]
    if source:
        versions.append(("other", Path(source)))
    built = _cuda.build_versions("thomas", versions)
    for name, (_, report, path) in built.items():
        for kern, r in report.items():
            print(f"# {name}: {kern}: {r['registers']} registers, "
                  f"{r['smem']} bytes shared, spills {r['spill_stores']} / "
                  f"{r['spill_loads']} bytes", flush=True)
        if sass_dir:
            Path(sass_dir).mkdir(parents=True, exist_ok=True)
            sass(path, Path(sass_dir) / f"thomas_{name}.sass")
    if hasattr(built["this"][0], "tpuslam_thomas_divcheck"):
        pairs, within, differ, wide = divcheck(built["this"][0])
        print(f"# fast division: {pairs} random pairs, {within} within its "
              f"checks, {differ} of them differ from IEEE division; the "
              f"small-value division differs on {wide}", flush=True)
        if differ or wide:
            raise AssertionError("K7's divisions differ from IEEE "
                                 "division")
    names = [v[0] for v in versions]
    order = names[::-1] + names          # e.g. other, this, this, other
    rows = []
    for shape, (D, S, B, lam) in systems(shapes).items():
        n, m = B.shape[0], B.shape[2]
        calls, outs = {}, {}
        for name, (lib, _, _) in built.items():
            full, X = solver(lib, D, S, B, lam)
            cut, _ = solver(lib, D, S, B, lam, stop=1)
            full()
            calls[name], outs[name] = (full, cut), X
        torch.cuda.synchronize()
        if n * m <= 60 * 400 or n <= BE_CUT:
            ref, what = DEV._thomas_solve(D, S, B, lam), "plain version"
        else:
            ref, what = outs["this"], "this version"
        equal = {k: bool(torch.equal(x, ref)) for k, x in outs.items()}
        times = {k: {"ms": [], "forward_ms": []} for k in built}
        for _ in range(turns):
            for name in order:
                full, cut = calls[name]
                times[name]["ms"].append(time_ms(full))
                if cut is not None:
                    times[name]["forward_ms"].append(time_ms(cut))
        for name, t in times.items():
            ms = statistics.median(t["ms"])
            fwd = statistics.median(t["forward_ms"]) \
                if t["forward_ms"] else None
            row = dict(version=name, shape=shape, n=n, m=m, ms=ms,
                       ms_turns=t["ms"], forward_ms=fwd,
                       backward_ms=None if fwd is None else ms - fwd,
                       step_us=ms * 1e3 / (2 * n),
                       equal_to=what, bit_equal=equal[name])
            rows.append(row)
            print(f"# K7 {name} at {n} x {m}: {ms:.4f} ms spun "
                  f"({row['step_us']:.3f} us per step; turns "
                  f"{[round(x, 4) for x in t['ms']]})" +
                  ("" if fwd is None else
                   f", forward pass {fwd:.4f} ms, backward {ms - fwd:.4f}"
                   f" ms") + f"; bit for bit the {what}: {equal[name]}",
                  flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", help="another version of csrc/thomas.cu")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--sass", help="write the kernels' SASS to this "
                    "directory")
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("thomas_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"# card: {smi}", flush=True)
    rows = run(args.source, args.turns, args.shapes, args.sass)
    print(json.dumps({"card": smi, "rows": rows}))


if __name__ == "__main__":
    sys.exit(main())
