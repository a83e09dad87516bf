"""The phase harness of kernel K1 (StereoBM): K1 cut after each phase on
the card, each cut held bit for bit to its plain PyTorch twin, and timed.

    python -m tpuslam_torch.tools.probe_bm_parts

Counterpart of tools/probe_bm_parts.py, the TPU probe that times the
Pallas strip kernel cut after each of its passes.  The cuts here are of
K1's own main-path kernel (csrc/stereo_bm.cu, `bm_packed_kernel<STOP>`),
at the same semantic points; kernels/stereo_bm.py PHASES lists them and
their two outputs:

    phase      probe's variant   what the phase adds
    prefilter  (its prefilter)   K1's launch 1, the X-Sobel prefilter
    vbox       pass1             staging and the vertical box pass
    boxes      mm                the horizontal box pass, 64 costs per pixel
    winner     p3min             the walk's first minimum over disparities
    sad        p3sad             the walk's two neighbour SADs
    uniq       p3uniq            the walk's far minimum, the uniqueness gate
    full       full              subpixel, gates, K1's outputs (K1 itself)

Input: the main path's first chunk, the first 30 frames of the bench
sequence (bench.py:30-37, rendered on the card).  A phase's time is the
device time of K1's prefilter launch and its kernel cut after the phase,
the median of 20 runs between CUDA events behind a ~1 ms spin
(tools/timing.py; the interquartile range beside it); its net time is what
it adds over the phase before.  The spin keeps the host's dispatch out of
the events, so no floor is subtracted (the probe subtracted one timed on
the host).  A phase that
times more than DROP_TOL below the phase before has lost work to the
compiler, and the harness raises.  Every cut of K1's kernel runs at K1's
blocks per SM (the launcher pads a cut that needs fewer registers or less
shared memory); the harness prints each cut's registers, shared memory
and blocks per SM.

Bound of each phase: what it adds, in bytes and 32-bit operations, at the
card's published peaks (below), and which of the two sets it.  Bytes: a
phase's function reads the pair once and writes its two outputs once, so
it adds the growth of its output bytes over the phase before.  Operations
per pixel (PHASE_WORK): the prefilter 16, and per plane (64 disparities
and the texture image) an absolute difference and a running sum's two
updates per box direction; a compare per disparity for the winner, two for
uniqueness; the epilogue about 20.  The full phase's bound counts more
than K1's row in chip_smoke.py (6 operations per pixel and disparity),
which leaves out the prefilter, the texture plane and the uniqueness gate.

Needs a CUDA card: without one it exits with an error; nothing falls back
to the plain version or to the CPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from ..config import StereoBMConfig
from ..kernels import _cuda
from ..kernels import stereo_bm as BM
from .timing import TIMING_RUNS, bound, call_ms, time_ms, times_ms

# the bench sequence (bench.py:30-37) and the main path's chunk
BENCH = dict(n_frames=120, width=1241, height=376, f=718.856, baseline=0.54,
             speed=1.4, yaw_rate=0.003, seed=11)
CHUNK = 30
# a phase may time this share below the phase before (noise), no more
DROP_TOL = 0.05
# per pixel: bytes of the phase's two outputs, operations the phase adds
PHASE_WORK = {"prefilter": (2, 16), "vbox": (8, 3 * 65),
              "boxes": (8, 2 * 65), "winner": (8, 64), "sad": (8, 2),
              "uniq": (8, 2 * 64), "full": (6, 20)}
PAIR_BYTES = 2


def phase_work(px: int):
    """{phase: (bytes it adds, operations it adds)} and the full phase's
    (bytes, operations), for `px` pixels."""
    added, prev_bytes, ops = {}, 0, 0
    for phase in BM.PHASES:
        out_bytes, phase_ops = PHASE_WORK[phase]
        nbytes = PAIR_BYTES + out_bytes
        added[phase] = (max(0, nbytes - prev_bytes) * px, phase_ops * px)
        prev_bytes = nbytes
        ops += phase_ops
    return added, (prev_bytes * px, ops * px)


def run(lefts: torch.Tensor, rights: torch.Tensor,
        cfg: StereoBMConfig = StereoBMConfig(), runs: int = TIMING_RUNS):
    """Every phase of K1 on the (B, H, W) uint8 pair on the card: held bit
    for bit to its plain twin (the full phase also to K1 itself) and
    timed.  Raises on a mismatch or a phase that lost work.  Returns the
    numbers: per phase ms, its interquartile range, net ms, share of the
    full phase, the bound of what it adds and its occupancy; the packed
    kernel's launch shape (stereo_bm_packed_shape); the full
    phase's ms, its unspun ms (host dispatch included), bound, and the ms
    of its plain twin and of K1 itself; the harness's launches."""
    n0 = _cuda.LAUNCHES["stereo_bm_phase"]
    k1 = BM.stereo_bm_cuda(lefts, rights, cfg)
    added, (full_bytes, full_ops) = phase_work(lefts.numel())
    phases, prev_ms, err = {}, 0.0, 0.0
    for phase in BM.PHASES:
        got = BM.stereo_bm_phase_cuda(lefts, rights, cfg, phase)
        want = BM.stereo_bm_phase_plain(lefts, rights, cfg, phase)
        refs = [("plain twin", want)] + ([("K1", k1)] if phase == "full"
                                         else [])
        for what, ref in refs:
            for i, (g, w) in enumerate(zip(got, ref)):
                diff = (g.long() - w.long()).abs()
                err = max(err, float(diff.max()))
                if g.dtype != w.dtype or diff.any():
                    raise AssertionError(
                        f"K1 phase {phase}: output {i} differs from the "
                        f"{what} at {int((diff != 0).sum())} pixels")
        ts = times_ms(lambda: BM.stereo_bm_phase_cuda(lefts, rights, cfg,
                                                      phase), runs)
        ms = statistics.median(ts)
        q1, _, q3 = statistics.quantiles(ts, n=4)
        if ms < (1 - DROP_TOL) * prev_ms:
            raise AssertionError(
                f"K1 phase {phase} times {ms:.3f} ms, below the phase "
                f"before ({prev_ms:.3f} ms): its work was dropped")
        b_ms, b_by = bound(*added[phase])
        phases[phase] = dict(ms=ms, iqr_ms=q3 - q1, net_ms=ms - prev_ms,
                             bound_ms=b_ms, bound_by=b_by)
        if phase != "prefilter":
            phases[phase].update(zip(
                ("registers", "smem_bytes", "blocks_per_sm"),
                BM.stereo_bm_phase_occupancy(phase, cfg)))
        prev_ms = ms
    for p in phases.values():
        p["share"] = p["net_ms"] / prev_ms
    plain_ms = time_ms(lambda: BM.stereo_bm_phase_plain(
        lefts, rights, cfg, "full"), runs)
    k1_ms = time_ms(lambda: BM.stereo_bm_cuda(lefts, rights, cfg), runs)
    full_call_ms = call_ms(lambda: BM.stereo_bm_phase_cuda(
        lefts, rights, cfg, "full"), runs)
    b_ms, b_by = bound(full_bytes, full_ops)
    return dict(phases=phases, shape=BM.stereo_bm_packed_shape(cfg),
                ms=prev_ms, call_ms=full_call_ms,
                plain_ms=plain_ms, k1_ms=k1_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                launches=_cuda.LAUNCHES["stereo_bm_phase"] - n0)


def table(res) -> str:
    """The per-phase breakdown as text, one row per phase."""
    lines = [f"{'phase':10s} {'ms':>9s} {'IQR ms':>7s} {'net ms':>9s} "
             f"{'share':>7s} {'bound ms':>9s} {'bound by':>10s} "
             f"{'regs':>5s} {'smem B':>7s} {'blocks/SM':>9s}"]
    for name, p in res["phases"].items():
        occ = (f"{p['registers']:5d} {p['smem_bytes']:7d} "
               f"{p['blocks_per_sm']:9d}" if "registers" in p
               else f"{'-':>5s} {'-':>7s} {'-':>9s}")
        lines.append(f"{name:10s} {p['ms']:9.3f} {p['iqr_ms']:7.3f} "
                     f"{p['net_ms']:9.3f} {100 * p['share']:6.1f}% "
                     f"{p['bound_ms']:9.4f} {p['bound_by']:>10s} {occ}")
    sh = res["shape"]
    lines.append(f"packed kernel: a {sh['columns']} x {sh['rows']} tile a "
                 f"block, {sh['registers']} registers, {sh['shared_bytes']} "
                 f"B shared memory, {sh['blocks_per_sm']} blocks per SM")
    lines.append(f"full phase: {res['ms']:.3f} ms (unspun "
                 f"{res['call_ms']:.3f} ms), K1 itself "
                 f"{res['k1_ms']:.3f} ms, plain twin {res['plain_ms']:.3f} "
                 f"ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
                 f"{res['launches']} launches")
    return "\n".join(lines)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_bm_parts: no CUDA device (torch.cuda."
                         "is_available() is False)")
    from ..io.synthetic import make_sequence
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    lefts, rights, _, _ = make_sequence(**BENCH)
    lefts = lefts[:CHUNK].contiguous()
    rights = rights[:CHUNK].contiguous()
    res = run(lefts, rights)
    print(f"# K1 phases on {CHUNK} x {BENCH['height']}x{BENCH['width']} "
          f"frames; card: {smi}")
    print(table(res))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
