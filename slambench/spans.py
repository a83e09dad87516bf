"""The program's own spans and counters (tpuslam_torch/runtime/perf.py),
read against the window and the card's trace: the split of `dispatch`.

A stream whose program records spans hands over `Span`s on
time.perf_counter_ns; `slambench/span_probe.py` runs a cell so.  Read
here:
- host ms a frame inside spans of given names, over the active frames of
  the `pipe.dispatch` spans that lie wholly in the window (the base of
  `dispatch_ms`; the spans under a pipe.dispatch count with it), and
  each part's share of `pipe.dispatch`;
- per span name, the device ns and the device operations of the trace
  whose launch call started inside such a span (CUPTI correlation ids,
  as `trace.summarize` keeps them for the harness's annotations);
- the share of the trace's CUDA runtime calls that start inside no
  program span of their process: the check that the spans sit on the
  trace's clock;
- the card's idle time by the innermost program span open in each
  stream at each gap's middle;
- the counters: decode and upload rates, node updates a chunk, and the
  check that `pipe.frames` is the spans' frame base.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np

from . import window

DISPATCH = "pipe.dispatch"
# pipe.dispatch's children, and theirs
DISPATCH_PARTS = ("vo.frontend", "vo.step", "dict.dispatch", "pipe.fetch")
FRONTEND_PARTS = ("fe.disparity", "fe.gftt", "fe.orb", "fe.lift")
STEP_PARTS = ("vo.match", "vo.ransac", "vo.refine", "vo.pose")
# host ms a frame: reading -> the span names it sums
HOST_MS = {"frontend_ms": ("vo.frontend",), "vo_match_ms": ("vo.match",),
           "vo_ransac_ms": ("vo.ransac",), "vo_refine_ms": ("vo.refine",),
           "ingest_wait_ms": ("ingest.next", "ingest.landed")}


class Span(NamedTuple):
    """A program span (the fields of tpuslam_torch's perf.SpanEvent)."""
    name: str
    start: int
    end: int
    id: int
    parent: int
    thread: int
    chunk: Any
    frames: int


def clock_offset() -> int:
    """time.time_ns() - time.perf_counter_ns(): what turns a perf_counter
    stamp into the trace's (ns since the epoch); the tightest of five
    paired reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


def shifted(spans, offset: int) -> list:
    return [s._replace(start=s.start + offset, end=s.end + offset)
            for s in spans]


def _union(iv) -> np.ndarray:
    iv = np.asarray(iv, np.int64).reshape(-1, 2)
    if len(iv) == 0:
        return iv
    return window.union(iv, int(iv[:, 0].min()), int(iv[:, 1].max()))


def _inside(u: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Whether each t lies in one of the sorted disjoint [start, end)
    intervals u."""
    t = np.asarray(t, np.int64)
    if len(u) == 0:
        return np.zeros(t.shape, bool)
    i = np.searchsorted(u[:, 0], t, side="right") - 1
    return (i >= 0) & (t < u[np.maximum(i, 0), 1])


def frames(spans, lo: int, hi: int) -> int:
    """Active frames of one stream's pipe.dispatch spans wholly in
    [lo, hi]."""
    return sum(s.frames for s in spans
               if s.name == DISPATCH and lo <= s.start and s.end <= hi)


def _counted(spans, lo: int, hi: int) -> list:
    """The spans of one stream that a reading over [lo, hi] counts: under
    a pipe.dispatch, those whose pipe.dispatch lies wholly in it (the
    frames' base); elsewhere, those that lie wholly in it themselves."""
    byid = {s.id: s for s in spans}
    out = []
    for s in spans:
        top = s
        while top.parent in byid:
            top = byid[top.parent]
        if top.name != DISPATCH:
            top = s
        if lo <= top.start and top.end <= hi:
            out.append(s)
    return out


def host_ms_per_frame(streams, names, lo: int, hi: int):
    """Host ms a frame inside spans named in `names`, over the streams'
    frames in [lo, hi]; `streams` holds each stream's spans (span ids are
    a stream's own).  None without frames."""
    ns = n = 0
    for spans in streams:
        n += frames(spans, lo, hi)
        ns += sum(s.end - s.start for s in _counted(spans, lo, hi)
                  if s.name in names)
    return ns / 1e6 / n if n else None


def self_ms_per_frame(streams, name: str, lo: int, hi: int):
    """Host ms a frame in spans `name` outside their direct children."""
    ns = n = 0
    for spans in streams:
        n += frames(spans, lo, hi)
        own = {s.id: s.end - s.start for s in _counted(spans, lo, hi)
               if s.name == name}
        ns += sum(own.values()) - sum(s.end - s.start for s in spans
                                      if s.parent in own)
    return ns / 1e6 / n if n else None


def dispatch_split(streams, lo: int, hi: int) -> dict:
    """pipe.dispatch and each part, ms a frame; `self` is pipe.dispatch
    outside its children, `covered` the children's share of it."""
    out = {n: host_ms_per_frame(streams, (n,), lo, hi)
           for n in (DISPATCH,) + DISPATCH_PARTS + FRONTEND_PARTS +
           STEP_PARTS}
    whole = out[DISPATCH]
    out["self"] = self_ms_per_frame(streams, DISPATCH, lo, hi)
    out["covered"] = (1.0 - out["self"] / whole) if whole else None
    return out


def trace_reading(prof, start_ns: int, stop_ns: int, spans) -> dict:
    """From a stopped torch profiler and this process's spans on the
    trace's clock: `by_span` name -> [device ns, device operations] of
    the operations launched inside such spans; `calls` the CUDA runtime
    calls with a correlation id that start in [start_ns, stop_ns] and
    `unattributed` those of them that start inside no span; `frames` the
    active frames of the pipe.dispatch spans wholly in that window."""
    dev, corr, when = [], [], []
    is_dev = {}
    for e in prof.profiler.kineto_results.events():
        d = e.device_type()
        on_dev = is_dev.get(d)
        if on_dev is None:
            on_dev = is_dev[d] = str(d).endswith("CUDA")
        if on_dev:
            if not e.is_user_annotation():
                s = e.start_ns()
                dev.append((s, s + e.duration_ns(), e.correlation_id()))
        else:
            c = e.correlation_id()
            if c:
                corr.append(c)
                when.append(e.start_ns())
    d = np.array(dev, np.int64).reshape(-1, 3)
    corr = np.array(corr, np.int64)
    when = np.array(when, np.int64)
    order = np.argsort(corr, kind="stable")
    corr, when = corr[order], when[order]
    if len(corr):
        j = np.minimum(np.searchsorted(corr, d[:, 2]), len(corr) - 1)
        known = corr[j] == d[:, 2]
        launched = np.where(known, when[j], -1)
    else:
        known = np.zeros(len(d), bool)
        launched = np.full(len(d), -1, np.int64)
    by_span = {}
    for name in sorted({s.name for s in spans}):
        u = _union([(s.start, s.end) for s in spans if s.name == name])
        m = known & _inside(u, launched)
        by_span[name] = [int((d[m, 1] - d[m, 0]).sum()), int(m.sum())]
    calls = when[(when >= start_ns) & (when <= stop_ns)]
    out = ~_inside(_union([(s.start, s.end) for s in spans]), calls)
    return dict(by_span=by_span, calls=int(len(calls)),
                unattributed=int(out.sum()),
                frames=frames(spans, start_ns, stop_ns))


def _depths(spans) -> dict:
    """span id -> its depth by parent links (0: no parent among
    `spans`)."""
    byid = {s.id: s for s in spans}
    depth = {}
    for s in spans:
        chain = []
        cur = s
        while cur is not None and cur.id not in depth:
            chain.append(cur)
            cur = byid.get(cur.parent)
        base = depth[cur.id] + 1 if cur is not None else 0
        for k, c in enumerate(reversed(chain)):
            depth[c.id] = base + k
    return depth


def innermost(spans, t) -> tuple[list, np.ndarray]:
    """The innermost span open at each time t: the deepest by parent
    links, of equals the later started.  (names, codes): codes index
    names, -1 where no span is open."""
    t = np.asarray(t, np.int64)
    depth = _depths(spans)
    groups = {}
    for s in spans:
        groups.setdefault((s.thread, depth[s.id]), []).append(s)
    names = sorted({s.name for s in spans})
    code = {n: i for i, n in enumerate(names)}
    best_d = np.full(t.shape, -1, np.int64)
    best_s = np.zeros(t.shape, np.int64)
    best_n = np.full(t.shape, -1, np.int64)
    for (_, dep), ss in groups.items():
        ss.sort(key=lambda s: s.start)
        st = np.array([s.start for s in ss], np.int64)
        en = np.array([s.end for s in ss], np.int64)
        nm = np.array([code[s.name] for s in ss], np.int64)
        i = np.maximum(np.searchsorted(st, t, side="right") - 1, 0)
        ok = (t >= st[i]) & (t < en[i])
        better = ok & ((dep > best_d) | ((dep == best_d) & (st[i] > best_s)))
        best_d[better] = dep
        best_s[better] = st[i][better]
        best_n[better] = nm[i][better]
    return names, best_n


def idle_by_span(intervals, lo: int, hi: int, streams) -> list:
    """The idle time of [lo, hi] by what the streams were in at each gap's
    middle: the innermost program span open in each stream there, a gap's
    time shared equally by the streams that have one open; a gap in which
    no stream has one goes by the harness span names open then, as
    window.idle_by_state names it.  `streams`: per stream, (program
    spans, harness spans), both on the trace's clock.  [[state, seconds],
    ...], longest first."""
    g = window.gaps(intervals, lo, hi)
    if len(g) == 0 or not streams:
        return []
    mid = (g[:, 0] + g[:, 1]) // 2
    inner = [innermost(prog, mid) for prog, _ in streams]
    named = sum((code >= 0).astype(np.int64) for _, code in inner)
    sec = (g[:, 1] - g[:, 0]) / 1e9 / np.maximum(named, 1)
    out = {}
    for names, code in inner:
        per = np.bincount(code[code >= 0], weights=sec[code >= 0],
                          minlength=len(names))
        for n, v in zip(names, per):
            if v:
                out[n] = out.get(n, 0.0) + float(v)
    if (named == 0).any():
        # the gaps a program span names count as busy for the harness's
        # reading, which so sees exactly the others
        busy = np.concatenate([np.asarray(intervals, np.int64)
                               .reshape(-1, 2), g[named > 0]])
        hspans = [s for _, h in streams for s in h]
        for k, v in window.idle_by_state(busy, lo, hi, hspans):
            out[k] = out.get(k, 0.0) + v
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])


def counter_readings(counters: dict, streams, seconds: float) -> dict:
    """The readings of the program's counters, summed over the streams,
    over a window of `seconds` in which the recorder was on: the ingest's
    decode rate (frames/s) and upload rate (MB/s), the bytes uploaded a
    decoded frame, the chunk dictionary's node updates a chunk, and the
    check of the frames' base: pipe.frames and pipe.chunks against the
    frames and the number of the recorded pipe.dispatch spans, which
    exceed them by at most the chunk open at each of the window's edges
    in each stream (it counts, but records no span)."""
    c = counters.get
    disp = [s for each in streams for s in each if s.name == DISPATCH]
    decoded, chunks = c("ingest.frames", 0), c("pipe.chunks", 0)
    return dict(
        decode_fps=decoded / seconds,
        upload_mb_s=c("ingest.bytes", 0) / 1e6 / seconds,
        upload_bytes_per_frame=(c("ingest.bytes", 0) / decoded
                                if decoded else None),
        dict_nodes_per_chunk=c("dict.nodes", 0) / chunks if chunks else None,
        frames_counted=c("pipe.frames", 0),
        frames_in_spans=sum(s.frames for s in disp),
        chunks_counted=chunks, chunks_in_spans=len(disp))
