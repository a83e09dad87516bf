"""K1's wide and packed kernels (csrc/stereo_bm.cu, `bm_wide_kernel`,
`bm_packed_kernel`) on the card, timed in turns with another version of
the source.

    python -m tpuslam_torch.tools.bm_wide_probe [--source FILE ...]
        [--turns N] [--cases CASE ...]

Builds csrc/stereo_bm.cu and, with --source, each FILE (another version
of it with the same launcher `tpuslam_stereo_bm`, e.g. a parent's from an
unpacked archive; named `other` where there is one, else by its file
name) with `-Xptxas -v`, in parallel (`_cuda.build_versions`), and
renders the bench's first 30-frame chunk (tools/probe_bm_parts.py
BENCH).  At each case of CASES each version's K1 is held bit for bit to
the plain version (disparity and min-SAD) and timed with tools/timing.py
(spun `time_ms`, unspun `call_ms`), the versions in turns (backwards,
then forwards: FILE, this, this, FILE for one FILE), N times; the plain
version is timed once.  The cases: the wide kernel at chip_smoke.py's
seven configurations (K1_WIDE), six on one frame and 128 disparities on
the chunk; at the main path's configuration on the chunk, K1's main-path
kernel (`main`, the main path's launch: this version's packed kernel)
and the wide kernel launched in its place (`main_wide`, which the main
path never runs).
Prints each case's bound (tools/timing.py `bound`: the pair in and the two
outputs, 8 bytes a pixel; 6 operations a pixel and disparity), this
version's launch shape (`stereo_bm_wide_shape`,
`stereo_bm_packed_shape`) and each kernel's registers, shared memory and
spills, then one JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..config import StereoBMConfig
from ..kernels import _cuda, stereo_bm as BM
from .probe_bm_parts import BENCH, CHUNK
from .timing import bound, call_ms, time_ms

# case -> (StereoBMConfig keywords, frames of the chunk, wide kernel)
CASES = {
    "ndisp1": (dict(num_disparities=1), 1, True),
    "ndisp32": (dict(num_disparities=32), 1, True),
    "ndisp80": (dict(num_disparities=80), 1, True),
    "block33": (dict(prefilter_cap=15, block_size=33), 1, True),
    "block51": (dict(prefilter_cap=31, block_size=51), 1, True),
    "cost": (dict(prefilter_cap=63, block_size=23), 1, True),
    "ndisp128": (dict(num_disparities=128, min_disparity=-5), CHUNK, True),
    "main": ({}, CHUNK, False),
    "main_wide": ({}, CHUNK, True),
}


def k1_call(lib, left, right, cfg, wide):
    """A call of the library's K1 on the (B, H, W) pair, its main-path
    kernel or the wide kernel.  Returns (call, (disp, minsad))."""
    fn = lib.tpuslam_stereo_bm
    fn.argtypes, fn.restype = _cuda.SIGNATURES["stereo_bm"][1], ctypes.c_int
    lp, rp = torch.empty_like(left), torch.empty_like(right)
    disp = torch.empty_like(left, dtype=torch.int16)
    minsad = torch.empty_like(left, dtype=torch.int32)
    B, H, W = left.shape
    args = [t.data_ptr() for t in (left, right, lp, rp, disp, minsad)] + [
        B, H, W, cfg.block_size // 2, cfg.min_disparity, cfg.prefilter_cap,
        cfg.uniqueness_ratio, cfg.texture_threshold, cfg.num_disparities,
        int(wide)]

    def call():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    return call, (disp, minsad)


def run(lefts, rights, sources=(), turns=1, cases=CASES):
    """Build, hold and time; returns one row per case."""
    versions = [("this", _cuda.CSRC / "stereo_bm.cu")]
    for path in sources:
        versions.append(("other" if len(sources) == 1 else Path(path).stem,
                         Path(path)))
    built = _cuda.build_versions("stereo_bm", versions)
    for name, (_, report, _) in built.items():
        for kern, r in report.items():
            print(f"# {name}: {kern}: {r['registers']} registers, "
                  f"{r['smem']} bytes static shared, spills "
                  f"{r['spill_stores']} / {r['spill_loads']} bytes",
                  flush=True)
    names = [v[0] for v in versions]
    order = names[::-1] + names          # e.g. other, this, this, other
    rows = []
    for case, (kw, frames, wide) in cases.items():
        cfg = StereoBMConfig(**kw)
        lb, rb = lefts[:frames].contiguous(), rights[:frames].contiguous()
        px = lb.numel()
        want = BM.stereo_bm_plain(lb, rb, cfg)
        calls, equal = {}, {}
        for name, (lib, _, _) in built.items():
            calls[name], outs = k1_call(lib, lb, rb, cfg, wide)
            calls[name]()
            torch.cuda.synchronize()
            equal[name] = all(torch.equal(a, b) for a, b in zip(outs, want))
            if not equal[name]:
                raise AssertionError(f"K1 ({name}, {case}) differs from "
                                     f"the plain version")
        ms = {k: [] for k in built}
        unspun = {k: [] for k in built}
        for _ in range(turns):
            for name in order:
                ms[name].append(time_ms(calls[name]))
                unspun[name].append(call_ms(calls[name]))
        b_ms, b_by = bound(8 * px, 6 * cfg.num_disparities * px)
        row = dict(case=case, config=kw, frames=frames, wide=wide,
                   bound_ms=b_ms, bound_by=b_by, bytes=8 * px,
                   ops=6 * cfg.num_disparities * px,
                   plain_ms=time_ms(lambda: BM.stereo_bm_plain(lb, rb, cfg)),
                   valid=float((want[0] >= 0).float().mean()),
                   shape=(BM.stereo_bm_wide_shape if wide else
                          BM.stereo_bm_packed_shape)(cfg))
        for name in built:
            row[name] = dict(ms=statistics.median(ms[name]),
                             ms_turns=ms[name],
                             call_ms=statistics.median(unspun[name]),
                             bit_equal=equal[name])
        rows.append(row)
        print(f"# K1 {case} ({frames} x {lb.shape[1]}x{lb.shape[2]}, "
              f"{'wide' if wide else 'packed'} kernel): " + "; ".join(
                  f"{n} {row[n]['ms']:.4f} ms spun (turns "
                  f"{[round(x, 4) for x in row[n]['ms_turns']]}), "
                  f"{row[n]['call_ms']:.4f} unspun" for n in built) +
              f"; plain {row['plain_ms']:.3f} ms; bound {b_ms:.5f} ms "
              f"({b_by}); bit for bit the plain version; shape "
              f"{row['shape']}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", nargs="+", default=[],
                    help="other versions of csrc/stereo_bm.cu")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--cases", nargs="*", default=list(CASES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bm_wide_probe: needs a CUDA device")
    from ..io.synthetic import make_sequence
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"# card: {smi}", flush=True)
    lefts, rights, _, _ = make_sequence(**BENCH)
    lefts, rights = lefts[:CHUNK].contiguous(), rights[:CHUNK].contiguous()
    rows = run(lefts, rights, args.source, args.turns,
               {c: CASES[c] for c in args.cases})
    print(json.dumps({"card": smi, "rows": rows}))


if __name__ == "__main__":
    sys.exit(main())
