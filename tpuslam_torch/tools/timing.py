"""Device time of one call on the card, for chip_smoke.py and the K1 phase
harness (probe_bm_parts.py).

`times_ms` records a CUDA event, calls fn and records another, after one
warm-up call.  With `spin` (the default) a ~1 ms spin kernel is queued
before the start event, so the card is still busy while the host runs the
wrapper's Python and dispatches fn: the events then hold the kernels' own
time.  Without the spin the start event is recorded on an idle card and
the time includes the host's dispatch (`call_ms`, what chip_smoke.py
reported as a kernel's time up to PR 6).  `floor_ms` is the spun time of
an empty spin, `torch.cuda._sleep(0)`: one launch between two events, the
least any spun time can read.

`bound` is the least time the card could take for a function's bytes and
32-bit operations, at the H100 SXM's published peaks.
"""

from __future__ import annotations

import statistics

import torch

# published H100 SXM peaks (NVIDIA H100 datasheet): HBM bytes/s and
# 32-bit non-tensor operations/s (132 SMs x 128 FP32 lanes x an FMA's two
# operations x 1.98 GHz).  K1's integer work is counted at the same rate:
# its 64 INT32 lanes an SM issue packed instructions (a VABSDIFF4 is four
# byte absolute differences, an add on a word of two 16-bit lanes two
# sums), and every value it sums fits 16 bits, so is exact in FP32 too
HBM_BPS, OPS_32 = 3.35e12, 67e12
TIMING_RUNS = 20
SPIN_CYCLES = 2_000_000              # ~1 ms at the H100's clocks


def times_ms(fn, runs=TIMING_RUNS, spin=True):
    """Device times of fn() in ms over `runs` calls (CUDA events), after
    one warm-up call; behind a ~1 ms spin unless `spin` is False."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def time_ms(fn, runs=TIMING_RUNS):
    """Median spun device time of fn() in ms: the kernels' own time."""
    return statistics.median(times_ms(fn, runs))


def call_ms(fn, runs=TIMING_RUNS):
    """Median unspun time of fn() in ms: the host's dispatch included."""
    return statistics.median(times_ms(fn, runs, spin=False))


def floor_ms(runs=TIMING_RUNS):
    """The spun time of an empty launch, the floor of any spun time."""
    return time_ms(lambda: torch.cuda._sleep(0), runs)


def bound(nbytes, ops):
    """Least time in ms for moving `nbytes` and doing `ops` 32-bit
    operations at the card's peaks, and which of the two sets it."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / OPS_32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")
