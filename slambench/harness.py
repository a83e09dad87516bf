"""Streams, their window and what a run prints.

`run` starts the traffic mix's streams (in this process for one stream,
in spawned worker processes for more), holds them at a barrier after
their set-up, opens the window for all at one perf_counter instant (the
system-wide monotonic clock, the same in every process), gathers what
each reports, and turns it into the end-to-end or per-layer metrics of
the cell, the device record, the breakdown of a traced run and the
checks.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
from dataclasses import dataclass

import numpy as np

from . import check, window
from .run import foreign_modules, load_module

# seconds a stream may take for its set-up, and for its check after the
# window, before the run gives up on it
SETUP_TIMEOUT = 600.0
AFTER_TIMEOUT = 300.0


class StreamFailed(RuntimeError):
    """A stream raised, or never reported."""


def stream_main(index, seed, config, traffic, seconds, tracing, send, go,
                device="cuda", faults=(), cores=None):
    """One stream's life: set-up, barrier, window, check.  `send(kind,
    payload)` reports; `go()` blocks until the window opens and returns
    its perf_counter start.  With `cores`, the window runs on those host
    cores: the calling thread and every thread it starts from then on.
    Both reports name the JAX modules loaded by then: the "window" one as
    the window closes, the "check" one after the reference has run."""
    from .stream import Stream, stream_seed_rng
    import torch
    stream = Stream(index, seed, config, traffic, device, faults)
    try:
        stream.setup()
        send("ready", None)
        t0 = go()
        if cores:
            os.sched_setaffinity(0, cores)
        trace_from = t0 + traffic["trace_from"] * seconds if tracing \
            else None
        stream.run_window(t0, seconds, trace_from)
        kp = [c[2]["n_kpts"][:c[1]] for rp in stream.replays
              for c in rp.chunks]
        send("window", dict(
            completions=stream.completions, spans=stream.span_ns(),
            peak_bytes=stream.peak_bytes,
            kpts_per_frame=float(np.mean(np.concatenate(kp))) if kp else 0.0,
            frames=sum(c[1] for rp in stream.replays for c in rp.chunks),
            trace=stream.trace_summary, clock_offset=stream.clock_offset,
            modules=foreign_modules()))
        stream.free_program()
        with torch.no_grad():
            nums = check.stream_numbers(stream, stream_seed_rng(seed, index))
        send("check", dict(numbers=nums, modules=foreign_modules()))
    finally:
        stream.close()


def _worker(index, seed, config, traffic, seconds, tracing, q, go_event,
            t0_value, device, cores, faults):
    """A spawned stream: reports through queue `q`.  With `cores`, it
    runs on those host cores only, its threads too."""
    if cores:
        os.sched_setaffinity(0, cores)
    from .stream import env_threads
    env_threads()
    import torch
    torch.set_num_threads(1)

    def send(kind, payload):
        q.put((index, kind, payload))

    def go():
        go_event.wait()
        return t0_value.value

    try:
        stream_main(index, seed, config, traffic, seconds, tracing, send, go,
                    device, faults)
    except BaseException:
        q.put((index, "error", traceback.format_exc()))
        raise


@dataclass
class Gathered:
    t0: float
    setup_s: float
    window: dict       # stream index -> its "window" report
    checks: dict       # stream index -> its check numbers
    modules: list      # JAX modules that any stream had loaded, window or
                       # check


def _run_local(spec, seed, seconds, tracing, t_start, device="cuda",
               faults=()):
    got = {}

    def send(kind, payload):
        got[kind] = payload

    t0 = []

    def go():
        t0.append(time.perf_counter())
        return t0[0]

    cores = stream_cores(1, spec["traffic"].get("cores_per_stream", 0))[0]
    stream_main(0, seed, spec["config"], spec["traffic"], seconds, tracing,
                send, go, device, faults, cores)
    return Gathered(t0[0], t0[0] - t_start, {0: got["window"]},
                    {0: got["check"]["numbers"]},
                    _modules([got["window"], got["check"]]))


def _modules(reports) -> list:
    return sorted({m for r in reports for m in r["modules"]})


def _get(q, timeout: float, procs):
    """The next report; raise StreamFailed on an error report, or when a
    worker has died or the time runs out."""
    end = time.monotonic() + timeout
    while True:
        try:
            index, kind, payload = q.get(timeout=1.0)
        except queue.Empty:
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if dead or time.monotonic() > end:
                raise StreamFailed(f"a stream stopped reporting "
                                   f"(exit codes {dead})") from None
            continue
        if kind == "error":
            raise StreamFailed(f"stream {index} failed:\n{payload}")
        return index, kind, payload


def stream_cores(n: int, per: int) -> list:
    """Disjoint sets of `per` host cores for n streams, from the cores
    this process may use; no pinning (None each) when per is 0 or there
    are too few."""
    have = sorted(os.sched_getaffinity(0))
    if per <= 0 or len(have) < n * per:
        return [None] * n
    return [set(have[i * per:(i + 1) * per]) for i in range(n)]


def _run_fleet(spec, seed, seconds, tracing, t_start, device="cuda",
               faults=()):
    import tpuslam_torch.io.native_loader as NL
    from tpuslam_torch.kernels import _cuda
    # build once here, not in every worker at once (first run only)
    if device != "cpu":
        _cuda.build_all(_cuda.KERNELS)
    NL.build()
    n = spec["traffic"]["streams"]
    cores = stream_cores(n, spec["traffic"].get("cores_per_stream", 0))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    go_event = ctx.Event()
    t0_value = ctx.Value("d", 0.0)
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(i, seed, spec["config"], spec["traffic"],
                               seconds, tracing, q, go_event, t0_value,
                               device, cores[i], faults))
             for i in range(n)]
    for p in procs:
        p.start()
    try:
        ready = set()
        while len(ready) < n:
            index, kind, _ = _get(q, SETUP_TIMEOUT, procs)
            ready.add(index)
        t0 = time.perf_counter()
        t0_value.value = t0
        go_event.set()
        win, checks = {}, {}
        while len(checks) < n:
            index, kind, payload = _get(q, seconds + AFTER_TIMEOUT, procs)
            (win if kind == "window" else checks)[index] = payload
        for p in procs:
            p.join(timeout=60)
        return Gathered(t0, t0 - t_start, win,
                        {i: c["numbers"] for i, c in checks.items()},
                        _modules([*win.values(), *checks.values()]))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


def gather(spec, seed, seconds, tracing, t_start) -> Gathered:
    if spec["traffic"]["streams"] == 1:
        return _run_local(spec, seed, seconds, tracing, t_start)
    return _run_fleet(spec, seed, seconds, tracing, t_start)


class Context:
    """What a per-layer metric's reader reads (slambench/metrics/)."""

    def __init__(self, g: Gathered, spec: dict, seconds: float):
        self.g = g
        self.spec = spec
        self.t0 = g.t0
        self.t1 = g.t0 + seconds
        self.spans = [s for w in g.window.values() for s in w["spans"]]
        traces = [w["trace"] for w in g.window.values() if w["trace"]]
        self.traces = traces
        if traces:
            self.trace_lo = max(t["start_ns"] for t in traces)
            self.trace_hi = min(t["stop_ns"] for t in traces)

    def _ns(self, t: float) -> int:
        """perf_counter seconds -> the spans' clock (ns since the epoch)."""
        w = next(iter(self.g.window.values()))
        return int(t * 1e9) + w["clock_offset"]

    def span_ms_per_frame(self, name: str):
        return window.span_ms_per_frame(self.spans, name, self._ns(self.t0),
                                        self._ns(self.t1))

    def traced(self) -> bool:
        return bool(self.traces) and self.trace_hi > self.trace_lo

    def intervals(self):
        return np.concatenate([t["intervals"] for t in self.traces]) \
            if self.traces else np.zeros((0, 2), np.int64)

    def busy_ns(self) -> int:
        return window.busy_ns(self.intervals(), self.trace_lo, self.trace_hi)

    def idle_pct(self):
        if not self.traced():
            return None
        span = self.trace_hi - self.trace_lo
        return 100.0 * (1.0 - self.busy_ns() / span)

    def kernels(self, base: bool = False) -> dict:
        """kernel name (`trace.display_name`, or with `base` its name
        without template arguments) -> [device ns, launches], over the
        streams."""
        from .trace import base_name
        out = {}
        for t in self.traces:
            for k, (ns, c) in t["kernels"].items():
                o = out.setdefault(base_name(k) if base else k, [0, 0])
                o[0] += ns
                o[1] += c
        return out

    def annotated_ms_per_frame(self, name: str):
        """Device ms a frame of the kernels launched inside the harness's
        annotation `name`, over the calls that the trace holds; a call
        covers a chunk."""
        ns = sum(t["annotated"].get(name, [0, 0])[0] for t in self.traces)
        calls = sum(t["annotated"].get(name, [0, 0])[1] for t in self.traces)
        if not calls or not ns:
            return None
        return ns / 1e6 / (calls * self.spec["config"]["pipeline"]["chunk"])

    def shape(self) -> dict:
        cam = self.spec["config"]["camera"]
        pl = self.spec["config"]["pipeline"]
        kp = [w["kpts_per_frame"] for w in self.g.window.values()]
        return dict(frames=pl["chunk"], height=cam["height"],
                    width=cam["width"], ndisp=pl["bm"]["num_disparities"],
                    capacity=pl["capacity"],
                    kpts_per_frame=float(np.mean(kp)) if kp else 0.0)

    def roofline(self, names) -> float | None:
        """100 x the least time of the calls of the kernels `names`
        (slambench/roofline/<name>.py) over their device time in the
        trace; None when the trace holds none of their launches."""
        from .roofline_peaks import least_ms
        kern = self.kernels(base=True)
        shape = self.shape()
        bound_ms = dev_ms = 0.0
        for name in names:
            mod = load_module("roofline", name)
            calls = sum(kern.get(k, [0, 0])[1] for k in mod.CALLS)
            ns = sum(kern.get(k, [0, 0])[0] for k in mod.KERNELS)
            if calls and ns:
                bound_ms += calls * least_ms(*mod.cost(shape))
                dev_ms += ns / 1e6
        return 100.0 * bound_ms / dev_ms if dev_ms else None


def breakdown(ctx: Context) -> dict:
    kern = sorted(ctx.kernels().items(), key=lambda kv: -kv[1][0])[:10]
    idle = window.idle_by_state(ctx.intervals(), ctx.trace_lo, ctx.trace_hi,
                                ctx.spans)
    return dict(device_ops=[[k, v[0] / 1e9] for k, v in kern],
                idle_gaps=idle[:10])


def end_to_end(g: Gathered, seconds: float) -> dict:
    peak = sum(w["peak_bytes"] for w in g.window.values())
    fps = window.fleet_rate([w["completions"] for w in g.window.values()],
                            g.t0, g.t0 + seconds)
    return {"fps": fps, "stream_fps": fps, "setup_s": g.setup_s,
            "peak_mem_gib": peak / 2 ** 30}


def run(spec: dict, seed: int, seconds: float, tracing: bool,
        t_start: float, gathered: Gathered | None = None) -> dict:
    g = gathered or gather(spec, seed, seconds, tracing, t_start)
    if g.modules:
        raise StreamFailed(f"a stream loaded JAX or the JAX package: "
                           f"{g.modules}")
    limits = spec["config"]["limits"]
    correct, rows = check.judge(check.merge(list(g.checks.values()), limits),
                                limits)
    peak = sum(w["peak_bytes"] for w in g.window.values())
    device = {"platform": "gpu", "kind": None, "count": spec["cell"]["chips"],
              "memory_peak_bytes": int(peak)}
    metrics, extra = {}, {}
    if tracing:
        ctx = Context(g, spec, seconds)
        values = {m["name"]: load_module("metrics", m["name"]).read(ctx)
                  for m in spec["per_layer"]}
        if ctx.traced():
            device["busy_s"] = ctx.busy_ns() / 1e9
            device["window_s"] = (ctx.trace_hi - ctx.trace_lo) / 1e9
            extra["breakdown"] = breakdown(ctx)
    else:
        values = end_to_end(g, seconds)
    for m in spec["per_layer" if tracing else "end_to_end"]:
        if values.get(m["name"]) is not None:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": correct,
              "attempted": sum(w["frames"] for w in g.window.values()),
              "failed": sum(c["lost"] for c in g.checks.values()),
              "metrics": metrics, "device": device, **extra,
              "frames_checked": sum(c["frames_checked"]
                                    for c in g.checks.values()),
              "checks": {n: {"value": v, "limit": f"{op} {lim}"}
                         for n, v, op, lim in rows},
              "_rows": rows}
    return result
