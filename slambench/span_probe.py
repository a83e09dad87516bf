"""A cell's run with the program's span recorder on
(tpuslam_torch/runtime/perf.py): the split of `dispatch` that the cells'
metrics do not read yet.

    python -m slambench.span_probe --workload <cell> --seed <n>
                                   --seconds <s> --trace <0|1> [--out FILE]

The benchmark's harness runs the cell as `slambench.run` does (its
streams, window, metrics and check), with each stream a `ProbeStream`:
the program's recorder on from the window's start to its close, and,
traced, the clock offset that puts a perf_counter stamp on the trace's
clock read as the profiler starts and again as it stops (a stream reads
it otherwise at its construction, before a set-up of 20-70 s).  Each
stream prints that drift and the share of its CUDA runtime calls in the
trace that start inside no program span.  The last line of standard
output is the harness's result line, traced with "program" added: the
readings of `slambench/spans.py`.  Untraced, the end-to-end metrics are
the rate with the recorder on (each stream prints its span and counter
totals): against `slambench.run`'s on the same seed, what recording
costs.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import harness, run, spans, stream  # noqa: E402


class ProbeStream(stream.Stream):
    """A stream whose program records its spans and counters over the
    window."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.offsets = {"init": self.clock_offset}
        self.counters = {}
        self._prof = None

    def _wrap(self, pipe) -> None:
        super()._wrap(pipe)
        timed = pipe.dispatch

        def probe_dispatch(*args):
            starting = self.profiler is None and self.trace_from is not None
            off = spans.clock_offset() if starting else None
            out = timed(*args)
            if starting and self.profiler is not None:
                # the profiler started inside: the offset read just
                # before it, for the harness's spans and the program's
                self.offsets["start"] = self.clock_offset = off
            return out

        pipe.dispatch = probe_dispatch

    def _trace_stop(self) -> None:
        if self.profiler is not None:
            self.offsets["stop"] = spans.clock_offset()
            self._prof = self.profiler
        super()._trace_stop()

    def run_window(self, t0, seconds, trace_from=None) -> None:
        from tpuslam_torch.runtime import perf
        perf.drain()
        perf.enable()
        try:
            super().run_window(t0, seconds, trace_from)
        finally:
            perf.disable()
        events, self.counters = perf.drain()
        prog = [spans.Span(*e) for e in events]
        print(f"# stream {self.index} program spans {len(prog)} counters "
              f"{self.counters}", file=sys.stderr, flush=True)
        if self._prof is None or self.trace_summary is None:
            return
        on_trace = spans.shifted(prog, self.offsets["start"])
        reading = spans.trace_reading(self._prof, self.trace_start_ns,
                                      self.trace_stop_ns, on_trace)
        self._prof = None
        drift = self.offsets["stop"] - self.offsets["start"]
        share = reading["unattributed"] / max(reading["calls"], 1)
        print(f"# stream {self.index} clock offset drift {drift} ns over "
              f"the trace ({self.offsets['start'] - self.offsets['init']} "
              f"ns since set-up); CUDA runtime calls outside every program "
              f"span {reading['unattributed']} of {reading['calls']} "
              f"({100 * share:.3f} %)", file=sys.stderr, flush=True)
        self.trace_summary["program"] = dict(
            spans=prog, offsets=self.offsets, counters=self.counters,
            **reading)


_WORKER = harness._worker


def _probe_worker(*args):
    """harness._worker with ProbeStream in the spawned process."""
    stream.Stream = ProbeStream
    _WORKER(*args)


def report(g: harness.Gathered, spec: dict, seconds: float) -> dict:
    """The program's readings of a traced run: host ms a frame by span
    over the window, the split of pipe.dispatch, the trace's launches and
    device ms by span, each stream's drift and unattributed share, the
    idle time by innermost span, and the counters' readings."""
    suffix = ".fleet" if len(g.window) > 1 else ".stream"
    progs = [w["trace"]["program"] for w in g.window.values()
             if w["trace"] and "program" in w["trace"]]
    if len(progs) != len(g.window):
        return {}
    lo, hi = int(g.t0 * 1e9), int((g.t0 + seconds) * 1e9)
    each = [p["spans"] for p in progs]
    metrics = {name + suffix: spans.host_ms_per_frame(each, names, lo, hi)
               for name, names in spans.HOST_MS.items()}
    by = {}
    for p in progs:
        for name, (ns, ops) in p["by_span"].items():
            b = by.setdefault(name, [0, 0])
            b[0] += ns
            b[1] += ops
    tframes = sum(p["frames"] for p in progs)
    if tframes:
        metrics["launches_per_frame" + suffix] = \
            by.get(spans.DISPATCH, [0, 0])[1] / tframes
        if suffix == ".fleet":
            metrics["dict_device_ms.fleet"] = \
                by.get("dict.dispatch", [0, 0])[0] / 1e6 / tframes
    ctx = harness.Context(g, spec, seconds)
    idle = spans.idle_by_span(
        ctx.intervals(), ctx.trace_lo, ctx.trace_hi,
        [(spans.shifted(p["spans"], p["offsets"]["start"]), w["spans"])
         for p, w in zip(progs, g.window.values())])
    counters = {}
    for p in progs:
        for k, v in p["counters"].items():
            counters[k] = counters.get(k, 0) + v
    return dict(
        counters=spans.counter_readings(counters, each, seconds),
        metrics=metrics, split=spans.dispatch_split(each, lo, hi),
        trace_frames=tframes,
        device_by_span={k: dict(ms_per_frame=v[0] / 1e6 / tframes,
                                ops_per_frame=v[1] / tframes)
                        for k, v in sorted(by.items())} if tframes else {},
        unattributed_pct=[100 * p["unattributed"] / max(p["calls"], 1)
                          for p in progs],
        drift_ns=[p["offsets"]["stop"] - p["offsets"]["start"]
                  for p in progs],
        idle_gaps=idle[:16])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", help="also write the result line here")
    args = ap.parse_args(argv)
    spec = run.resolve(run.load_json("BENCHMARK.json"), args.workload)
    stream.env_threads()
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(os.getcwd(), "build", sub))
    import torch
    if not torch.cuda.is_available():
        print("span_probe: needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    stream.Stream = ProbeStream
    harness._worker = _probe_worker
    print(f"# device {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{run.power_limit()}; cell {args.workload} seed {args.seed} "
          f"seconds {args.seconds} trace {args.trace}", file=sys.stderr)
    g = harness.gather(spec, args.seed, args.seconds, bool(args.trace),
                       T_START)
    result = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                         T_START, gathered=g)
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    if args.trace:
        result["program"] = report(g, spec, args.seconds)
    for name, value, op, limit in result.pop("_rows"):
        print(f"# check {name} {value} {op} {limit}", file=sys.stderr)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
