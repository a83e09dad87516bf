"""The arithmetic of a window: frames per second between chunk
completions, spans per frame, and the union of device intervals."""

from __future__ import annotations

import numpy as np


def rate(completions, t0: float, t1: float):
    """Frames per second of one stream over the window [t0, t1] from its
    (time, frames) chunk completions: the frames of every chunk that
    completes after its first completion inside the window, over the time
    from that completion to its last one inside it.  None with fewer than
    two completions inside."""
    inside = sorted(c for c in completions if t0 <= c[0] <= t1)
    if len(inside) < 2 or inside[-1][0] <= inside[0][0]:
        return None
    frames = sum(n for _, n in inside[1:])
    return frames / (inside[-1][0] - inside[0][0])


def fleet_rate(streams, t0: float, t1: float):
    """The sum of the streams' rates (each stream's whole chunks between
    its own completions, so no stream's partial chunk enters); None if
    a stream has no rate."""
    rates = [rate(c, t0, t1) for c in streams]
    return None if any(r is None for r in rates) else sum(rates)


def span_ms_per_frame(spans, name: str, t0_ns: int, t1_ns: int):
    """Milliseconds a frame inside spans called `name` that lie wholly in
    [t0_ns, t1_ns]; spans are (name, start_ns, end_ns, frames).  For a
    span that carries no frames (the ingest wait), the frames are those of
    the dispatch spans in the window.  None when no frame counts."""
    inside = [s for s in spans if t0_ns <= s[1] and s[2] <= t1_ns]
    ns = sum(b - a for n, a, b, _ in inside if n == name)
    frames = sum(k for n, _, _, k in inside if n == name)
    if frames == 0:
        frames = sum(k for n, _, _, k in inside if n == "dispatch")
    return ns / 1e6 / frames if frames else None


def union(intervals: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The union of (n, 2) [start, end) intervals clipped to [lo, hi], as
    sorted disjoint (m, 2) intervals."""
    iv = np.asarray(intervals, np.int64).reshape(-1, 2)
    iv = np.clip(iv, lo, hi)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new run starts where an interval begins after every earlier end
    starts = np.ones(len(iv), bool)
    starts[1:] = iv[1:, 0] > ends[:-1]
    first = np.flatnonzero(starts)
    last = np.r_[first[1:] - 1, len(iv) - 1]
    return np.stack([iv[first, 0], ends[last]], axis=1)


def busy_ns(intervals, lo: int, hi: int) -> int:
    u = union(intervals, lo, hi)
    return int((u[:, 1] - u[:, 0]).sum())


def gaps(intervals, lo: int, hi: int) -> np.ndarray:
    """The idle (m, 2) intervals of [lo, hi] between the union's runs,
    longest first."""
    u = union(intervals, lo, hi)
    edges = np.r_[lo, u.reshape(-1), hi].reshape(-1, 2)
    g = edges[edges[:, 1] > edges[:, 0]]
    return g[np.argsort(g[:, 0] - g[:, 1], kind="stable")]


def idle_by_state(intervals, lo: int, hi: int, spans) -> list:
    """The idle time of [lo, hi] by what the hosts were in at each gap's
    middle: [[state, seconds], ...] longest first, a state being the
    names of the harness spans open then in any stream joined by '+', or
    'none'."""
    g = gaps(intervals, lo, hi)
    if len(g) == 0:
        return []
    mid = (g[:, 0] + g[:, 1]) // 2
    names = sorted({s[0] for s in spans})
    code = np.zeros(len(g), np.int64)
    for bit, name in enumerate(names):
        u = union([(a, b) for n, a, b, _ in spans if n == name], lo, hi)
        if len(u) == 0:
            continue
        i = np.searchsorted(u[:, 0], mid, side="right") - 1
        inside = (i >= 0) & (mid < u[np.maximum(i, 0), 1])
        code |= inside.astype(np.int64) << bit
    out = {}
    for c in np.unique(code):
        state = "+".join(n for b, n in enumerate(names) if c >> b & 1)
        out[state or "none"] = float((g[code == c, 1] - g[code == c, 0])
                                     .sum()) / 1e9
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])
