"""Block shapes of K2, K3's blur, K4 and K5 against each other, on the
card.

    python -m tpuslam_torch.tools.shape_sweep [SHAPE ...]

A SHAPE is `gftt:THxCPLxWARPS` (K2: strips of TH output rows, CPL
columns per lane, WARPS warps per block; -DGFTT_TH, -DGFTT_CPL,
-DGFTT_WARPS), `orb_blur:THxTWxNT` (K3's blur: a TH x TW output tile per
block of NT threads; -DORB_TH, -DORB_TW, -DORB_THREADS), `median:NT` (K4:
NT threads per row; -DMED_THREADS) or `lr_check:RxP` (K5: R image rows,
a warp each, per block, P columns per lane and pass; -DLR_ROWS,
-DLR_PIX).  Each shape's source (csrc/gftt.cu, orb.cu, median.cu,
lr_check.cu) is built once per shape with the file's own flags, all in
parallel, into build/tpuslam_torch/shape_sweep/.  K2 and the blur run on the first
30-frame chunk of the bench sequence (chip_smoke.py's, rendered on the
card) and are held bit for bit to gftt_response_dil_plain and orb_blur;
K5 runs on K1's disparity and min-SAD of that chunk and is held exactly
to lr_check_plain; K4 runs on chip_smoke.py's rows (N = 1536, ties,
+inf, count 0 and 1) and is held exactly to masked_median2_plain, then
timed on one row.  Every shape is timed behind the spin of
tools/timing.py, in turns over the shapes so that drift of the card's
clock spreads over all of them.  The shipped shapes are the sources'
defaults (the first of each kernel in SHAPES).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..config import SlamConfig
from ..kernels import _cuda
from ..kernels import gftt as G
from ..kernels import orb as O
from ..kernels import stereo_bm as BM
from ..vo import fused as F
from .timing import floor_ms, times_ms

N_FRAMES, WIDTH, HEIGHT, SEED, N_KEYS = 30, 1241, 376, 11, 1536
# the blur's shapes are those whose two f32 tiles fit in 48 KB of static
# shared memory
SHAPES = ("gftt:16x2x2", "gftt:16x2x4", "gftt:12x2x2", "gftt:24x2x2",
          "gftt:32x2x4", "gftt:16x1x4", "gftt:32x1x4", "gftt:16x4x2",
          "gftt:16x2x8",
          "orb_blur:8x256x128", "orb_blur:16x256x256", "orb_blur:16x256x128",
          "orb_blur:8x256x256", "orb_blur:32x128x256", "orb_blur:16x128x128",
          "orb_blur:16x192x256", "orb_blur:32x64x256", "orb_blur:64x64x256",
          "median:256", "median:128", "median:512", "median:1024",
          "lr_check:4x13", "lr_check:2x13", "lr_check:8x13", "lr_check:4x10",
          "lr_check:8x10", "lr_check:4x20", "lr_check:8x20", "lr_check:8x39",
          "lr_check:8x8")
# kernel -> (source, -D macros of a shape's fields, launcher, attributes
# query, its int arguments and its count of outputs)
KINDS = {
    "gftt": ("gftt", ("GFTT_TH", "GFTT_CPL", "GFTT_WARPS"), "tpuslam_gftt",
             "tpuslam_gftt_attrs", (), 6),
    "orb_blur": ("orb", ("ORB_TH", "ORB_TW", "ORB_THREADS"),
                 "tpuslam_orb_blur", "tpuslam_orb_attrs", (), 6),
    "median": ("median", ("MED_THREADS",), "tpuslam_masked_median2",
               "tpuslam_masked_median2_attrs", (N_KEYS,), 4),
    "lr_check": ("lr_check", ("LR_ROWS", "LR_PIX"), "tpuslam_lr_check",
                 "tpuslam_lr_check_attrs", (WIDTH,), 6),
}
ROUNDS, RUNS = 3, 20


def build(shapes):
    """{shape: (library, registers, shared bytes, local bytes)}, the
    libraries built in parallel."""
    out_dir = _cuda.BUILD_ROOT / "shape_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for shape in shapes:
        kind, dims = shape.split(":")
        src, macros = KINDS[kind][:2]
        defs = [f"-D{m}={v}" for m, v in zip(macros, dims.split("x"))]
        out = out_dir / f"lib{kind}_{dims}.so"
        cmd = ([_cuda._nvcc()] + _cuda.NVCC_FLAGS +
               _cuda.EXTRA_FLAGS.get(src, []) + defs +
               ["-o", str(out), str(_cuda.CSRC / f"{src}.cu")])
        procs[shape] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT), out)
    built = {}
    for shape, (proc, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {shape}:\n{log}")
        kind = shape.split(":")[0]
        lib = ctypes.CDLL(str(out))
        _, _, _, query, args, n = KINDS[kind]
        attrs = (ctypes.c_int * n)()
        fn = getattr(lib, query)
        fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
        rc = fn(*args, attrs)
        if rc != 0:
            raise RuntimeError(f"{query} of {shape}: cudaError {rc}")
        built[shape] = (lib, attrs[0], attrs[1], attrs[2])
    return built


@functools.lru_cache(maxsize=1)
def _chunk():
    """The first 30-frame chunk of the bench sequence, on the card."""
    from ..io.synthetic import make_sequence
    lefts, rights = make_sequence(N_FRAMES, WIDTH, HEIGHT, 718.856, 0.54,
                                  1.4, 0.003, SEED)[:2]
    return lefts.contiguous(), rights.contiguous()


def _median_rows():
    """chip_smoke.py's K4 rows: ties, +inf, count 0, count 1."""
    rng = np.random.default_rng(SEED)
    n = N_KEYS
    a = np.abs(rng.normal(0, 10, (5, n))).astype(np.float32)
    b = np.abs(rng.normal(0, 2, (5, n))).astype(np.float32)
    a[1] = np.round(a[1])
    a[2, ::3] = np.inf
    m = rng.uniform(size=(5, n)) < 0.5
    m[3] = False
    m[4] = False
    m[4, n // 3] = True
    return tuple(torch.as_tensor(v, device="cuda") for v in (a, b, m))


def _caller(kind, lib):
    """(check(), call()) of one built shape: check holds the kernel to its
    plain twin (raises otherwise), call launches it on the timed input."""
    def stream():
        return torch.cuda.current_stream().cuda_stream

    launcher = KINDS[kind][2]
    fn = getattr(lib, launcher)
    fn.restype = ctypes.c_int
    fn.argtypes = _cuda.SIGNATURES[kind][1]

    def launch(*args):
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args], stream())
        if rc != 0:
            raise RuntimeError(f"{launcher}: cudaError {rc}")

    if kind == "gftt":
        lefts = _chunk()[0]
        eig = torch.empty(lefts.shape, dtype=torch.float32,
                          device=lefts.device)
        dil = torch.empty_like(eig)

        def call():
            launch(lefts, eig, dil, *lefts.shape)

        def check():
            call()
            pe, pd = G.gftt_response_dil_plain(lefts)
            if not (torch.equal(eig.view(torch.int32), pe.view(torch.int32))
                    and torch.equal(dil, pd)):
                raise AssertionError("K2 differs from "
                                     "gftt_response_dil_plain")
        return check, call

    if kind == "lr_check":
        bm = SlamConfig().bm
        disp, minsad = BM.stereo_bm_cuda(*_chunk(), bm)
        out = torch.empty_like(disp)

        def call():
            launch(disp, minsad, out, *disp.shape, bm.min_disparity,
                   bm.num_disparities, bm.disp12_max_diff * 16)

        def check():
            call()
            if not torch.equal(out, BM.lr_check_plain(disp, minsad, bm)):
                raise AssertionError("K5 differs from lr_check_plain")
        return check, call

    if kind == "orb_blur":
        lefts = _chunk()[0]
        taps = O._gauss_taps(lefts.device)
        out = torch.empty_like(lefts)

        def call():
            launch(lefts, taps, out, *lefts.shape)

        def check():
            call()
            if not torch.equal(out, O.orb_blur(lefts)):
                raise AssertionError("blur differs from orb_blur")
        return check, call

    a, b, m = _median_rows()
    meds = torch.empty((5, 2), dtype=torch.float32, device="cuda")
    cnt = torch.empty(5, dtype=torch.int32, device="cuda")

    def check():
        launch(a, b, m, meds, cnt, 5, N_KEYS)
        pa, pb, pc = F.masked_median2_plain(a, b, m)
        if not (torch.equal(meds[:, 0], pa) and torch.equal(meds[:, 1], pb)
                and torch.equal(cnt.long(), pc)):
            raise AssertionError("K4 differs from masked_median2_plain")
    return check, lambda: launch(a, b, m, meds, cnt, 1, N_KEYS)


def run(shapes=SHAPES):
    """Every shape held to its plain twin and timed; returns rows."""
    rows = {}
    for shape, (lib, regs, smem, local) in build(shapes).items():
        check, call = _caller(shape.split(":")[0], lib)
        check()
        torch.cuda.synchronize()
        rows[shape] = dict(shape=shape, registers=regs, shared_bytes=smem,
                           local_bytes=local, call=call, ts=[])
    for _ in range(ROUNDS):
        for row in rows.values():
            row["ts"] += times_ms(row["call"], RUNS)
    for row in rows.values():
        ts = row.pop("ts")
        del row["call"]
        q1, _, q3 = statistics.quantiles(ts, n=4)
        row.update(ms=statistics.median(ts), iqr_ms=q3 - q1)
    return list(rows.values())


def _known(shape):
    """A kernel of KINDS with one positive integer per -D macro."""
    kind, _, dims = shape.partition(":")
    fields = dims.split("x")
    return (kind in KINDS and len(fields) == len(KINDS[kind][1]) and
            all(f.isdigit() and int(f) > 0 for f in fields))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("shapes", nargs="*", default=list(SHAPES))
    a = ap.parse_args(argv)
    for s in a.shapes:
        if not _known(s):
            raise SystemExit(f"shape_sweep: unknown shape {s}")
    if not torch.cuda.is_available():
        raise SystemExit("shape_sweep: no CUDA device (torch.cuda."
                         "is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    rows = run(a.shapes)
    floor = floor_ms()
    print(f"# K2, K3 blur, K4 and K5 shapes; card: {smi}; launch floor "
          f"{floor:.4f} ms")
    print(f"{'shape':22s} {'regs':>5s} {'smem B':>7s} {'local B':>8s} "
          f"{'ms':>8s} {'IQR ms':>7s}")
    for r in rows:
        print(f"{r['shape']:22s} {r['registers']:5d} {r['shared_bytes']:7d} "
              f"{r['local_bytes']:8d} {r['ms']:8.4f} {r['iqr_ms']:7.4f}")
    print(json.dumps({"floor_ms": floor, "card": smi, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
