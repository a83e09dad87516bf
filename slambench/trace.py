"""The card's trace over a part of the window, reduced to what the
per-layer metrics and the breakdown read.

torch.profiler records, through CUPTI, the card's kernels, copies and
sets and the host's CUDA runtime calls that launched them; it records no
host ops (recording the ~13k eager ops a frame doubled the host's time
and held ~2.7M events over 60 frames on the card).  The harness's own
spans (slambench/stream.py) are host times on the same clock, ns since
the epoch.  `summarize` keeps every device operation's interval, device
time and launches by kernel name (`display_name`), and, for each span name asked for, the
device time of the kernels whose launch call fell inside such a span.
"""

from __future__ import annotations

import bisect
import warnings

import numpy as np

def start(device):
    """A started profiler of the card (of the host ops on the CPU)."""
    from torch.profiler import ProfilerActivity, profile
    # one start and one stop: nothing accumulates across cycles
    warnings.filterwarnings("ignore", message="Warning: Profiler clears")
    acts = [ProfilerActivity.CUDA if device != "cpu" else
            ProfilerActivity.CPU]
    prof = profile(activities=acts)
    prof.start()
    return prof


def display_name(name: str) -> str:
    """A device operation's name without `void`, anonymous namespaces and
    its parameter list, at most 120 characters."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(n):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            n = n[:i]
            break
    return n.strip()[:120]


def base_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    return display_name(name).split("<", 1)[0]


def _inside(starts, ends, t) -> bool:
    """Whether t lies in one of the sorted disjoint [start, end) spans."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < ends[i]


def summarize(prof, start_ns: int, stop_ns: int, spans=()) -> dict:
    """`spans`: (name, start_ns, end_ns) host spans of this process whose
    kernels' device time to keep.  `prof` has stopped."""
    events = prof.profiler.kineto_results.events()
    is_dev = {}
    launches = {}            # correlation id -> host start of the call
    device = []              # (start, end, name, correlation id)
    for e in events:
        d = e.device_type()
        dev = is_dev.get(d)
        if dev is None:
            dev = is_dev[d] = str(d).endswith("CUDA")
        if dev:
            if not e.is_user_annotation():
                s = e.start_ns()
                device.append((s, s + e.duration_ns(), e.name(),
                               e.correlation_id()))
        else:
            c = e.correlation_id()
            if c:
                launches[c] = e.start_ns()
    kernels = {}
    for s, t, name, _ in device:
        k = kernels.setdefault(display_name(name), [0, 0])
        k[0] += t - s
        k[1] += 1
    by_name = {}
    for name, a, b in spans:
        if a >= start_ns and b <= stop_ns:
            by_name.setdefault(name, []).append((a, b))
    annotated = {}
    for name, sp in by_name.items():
        sp.sort()
        starts = [a for a, _ in sp]
        ends = [b for _, b in sp]
        ns = sum(t - s for s, t, _, c in device
                 if c in launches and _inside(starts, ends, launches[c]))
        annotated[name] = [ns, len(sp)]
    iv = np.array([(s, t) for s, t, _, _ in device], np.int64).reshape(-1, 2)
    return dict(start_ns=start_ns, stop_ns=stop_ns, intervals=iv,
                kernels=kernels, annotated=annotated)
