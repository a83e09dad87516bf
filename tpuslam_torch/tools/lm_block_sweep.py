"""Block shapes of kernel K6 (the LM refine) against each other, on the card.

    python -m tpuslam_torch.tools.lm_block_sweep [--n N] [--iters I]
        [--source FILE] [THREADSxPOINTS ...]

Builds csrc/lm_refine.cu, or FILE (another version of it, to compare two
in one call), once per block shape (-DLM_THREADS point threads,
-DLM_POINTS register-resident points each; `-Xptxas -v` for registers,
spills and stack frame), all in parallel, into
build/tpuslam_torch/lm_sweep/.  Each shape runs N points (the main path's
1536 by default) of a scene with a known pose (io/synthetic.py pnp_scene)
for I iterations (20), is held to the plain twin (rvec 1e-5, tvec 1e-4,
the same inliers at 2 px) and timed behind the spin of tools/timing.py,
in turns over the shapes so that drift of the card's clock spreads over
all of them.  A small N times the serial chain without the point pass;
I = 0 times the launch, the loads, one evaluation and the error pass.
The shipped shape is the source's default (the first row of SHAPES).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys

from pathlib import Path

import numpy as np
import torch

from ..kernels import _cuda
from ..kernels import pnp as P
from .timing import floor_ms, times_ms

SHAPES = ("384x4", "768x2", "352x5", "224x7", "480x4")
K_BENCH = np.array([[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157],
                    [0.0, 0.0, 1.0]])
ROUNDS, RUNS = 3, 20


def build(shapes, src):
    """{shape: (ctypes launcher, registers, spill bytes, stack frame
    bytes)} of `src`, built in parallel."""
    out_dir = _cuda.BUILD_ROOT / "lm_sweep" / Path(src).stem
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for shape in shapes:
        nt, ppt = shape.split("x")
        out = out_dir / f"liblm_{shape}.so"
        cmd = ([_cuda._nvcc()] + _cuda.NVCC_FLAGS +
               ["-Xptxas", "-v", f"-DLM_THREADS={nt}", f"-DLM_POINTS={ppt}",
                "-o", str(out), str(src)])
        procs[shape] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT), out)
    built = {}
    sym, argtypes = _cuda.SIGNATURES["lm_refine"]
    for shape, (proc, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {shape}:\n{log}")
        regs = re.search(r"Used (\d+) registers", log)
        spill = re.search(r"(\d+) bytes spill stores", log)
        stack = re.search(r"(\d+) bytes stack frame", log)
        fn = getattr(ctypes.CDLL(str(out)), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        built[shape] = (fn, *(int(m.group(1)) if m else -1
                              for m in (regs, spill, stack)))
    return built


def run(shapes=SHAPES, n=1536, iters=P.LM_ITERS,
        src=_cuda.CSRC / "lm_refine.cu"):
    """Every shape held to the plain twin and timed; returns rows."""
    from ..io.synthetic import pnp_scene
    args, _, _ = pnp_scene(np.random.default_rng(11), n, K_BENCH)
    obj, img, w, valid, K, rv0, tv0 = args
    pr, pt = P.refine_lm(obj, img, w, K, rv0, tv0, iters)
    pe = P.reproj_errors(obj, img, valid, K, pr, pt)
    p = torch.empty(6, dtype=torch.float32, device="cuda")
    err = torch.empty(n, dtype=torch.float32, device="cuda")
    ptrs = [a.data_ptr() for a in args] + [p.data_ptr(), err.data_ptr()]

    def call(fn):
        rc = fn(*ptrs, n, iters, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K6 failed to launch: cudaError {rc}")

    rows = {}
    for shape, (fn, regs, spill, stack) in build(shapes, src).items():
        call(fn)
        torch.cuda.synchronize()
        r_err = float((p[:3] - pr).abs().max())
        t_err = float((p[3:] - pt).abs().max())
        if not (r_err <= 1e-5 and t_err <= 1e-4 and
                torch.equal(err <= 2.0, pe <= 2.0)):
            raise AssertionError(f"K6 {shape} differs from the plain twin: "
                                 f"rvec {r_err}, tvec {t_err}")
        rows[shape] = dict(shape=shape, registers=regs, spill_bytes=spill,
                           stack_bytes=stack, rvec_err=r_err,
                           tvec_err=t_err, fn=fn, ts=[])
    for _ in range(ROUNDS):
        for row in rows.values():
            row["ts"] += times_ms(lambda: call(row["fn"]), RUNS)
    for row in rows.values():
        ts = row.pop("ts")
        del row["fn"]
        q1, _, q3 = statistics.quantiles(ts, n=4)
        row.update(ms=statistics.median(ts), iqr_ms=q3 - q1)
    return list(rows.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("shapes", nargs="*", default=list(SHAPES))
    ap.add_argument("--n", type=int, default=1536)
    ap.add_argument("--iters", type=int, default=P.LM_ITERS)
    ap.add_argument("--source", default=str(_cuda.CSRC / "lm_refine.cu"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lm_block_sweep: no CUDA device (torch.cuda."
                         "is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    rows = run(a.shapes, a.n, a.iters, a.source)
    floor = floor_ms()
    print(f"# K6 block shapes of {a.source}, N = {a.n}, {a.iters} "
          f"iterations; "
          f"card: {smi}; launch floor {floor:.4f} ms")
    print(f"{'shape':8s} {'regs':>5s} {'spill B':>8s} {'stack B':>8s} "
          f"{'ms':>8s} {'IQR ms':>7s} {'rvec err':>9s} {'tvec err':>9s}")
    for r in rows:
        print(f"{r['shape']:8s} {r['registers']:5d} {r['spill_bytes']:8d} "
              f"{r['stack_bytes']:8d} {r['ms']:8.4f} {r['iqr_ms']:7.4f} "
              f"{r['rvec_err']:9.2e} {r['tvec_err']:9.2e}")
    print(json.dumps({"source": a.source, "n": a.n, "iters": a.iters,
                      "floor_ms": floor, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
