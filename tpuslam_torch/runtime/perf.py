"""Named-span profiler, and the port's span and counter recorder.

`Perf` is the twin of the reference's Perf (src/slam/src/core/Perf.cpp):
startTime/stopTime pairs accumulate per-frame x per-function milliseconds
into a table written as CSV (perf_time.csv), plus frame time-log markers.
Copied from tpuslam/runtime/perf.py, but for `Perf.span`, which also
records an event while the recorder is on.  Device work is timed
host-side; callers that need exact device timing end their spans with
`torch.cuda.synchronize()`.

The recorder is process-wide and off by default.  While off, `span(name)`
returns one shared no-op context manager and `count` returns at once: one
attribute check a call, no allocation.  While on (`enable()`), each span
records a `SpanEvent`: its name, its start and end on `time.perf_counter_ns`,
its own id, its parent's id (the span open on the same thread when it
began, through a per-thread stack; 0 for none), the thread's native id, the
chunk it belongs to (given, else its parent's) and a frame count.  Counters
are host integers summed by name.  Nothing here reads a device value:
a span or a counter never synchronises with the device.  `drain()` hands
out the events and counters kept so far and clears them.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Any, NamedTuple


class SpanEvent(NamedTuple):
    name: str
    start_ns: int           # time.perf_counter_ns
    end_ns: int
    id: int
    parent: int             # the enclosing span's id on this thread, or 0
    thread: int             # threading.get_native_id()
    chunk: Any              # (replay, first frame) of the chunk, or None
    frames: int


class _Recorder:
    def __init__(self):
        self.on = False
        self.events: list[SpanEvent] = []
        self.counters: dict[str, int] = {}
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        loc = self.local
        try:
            return loc.stack
        except AttributeError:
            loc.stack = []
            loc.tid = threading.get_native_id()
            return loc.stack


RECORDER = _Recorder()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "chunk", "frames", "id", "parent", "t0")

    def __init__(self, name: str, chunk, frames: int):
        self.name = name
        self.chunk = chunk
        self.frames = frames

    def __enter__(self):
        st = RECORDER.stack()
        up = st[-1] if st else None
        self.id = next(RECORDER.ids)
        self.parent = up.id if up is not None else 0
        if self.chunk is None and up is not None:
            self.chunk = up.chunk
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        RECORDER.stack().pop()
        # a span still open when the recorder was turned off is dropped
        if RECORDER.on:
            ev = SpanEvent(self.name, self.t0, t1, self.id, self.parent,
                           RECORDER.local.tid, self.chunk, self.frames)
            with RECORDER.lock:
                RECORDER.events.append(ev)
        return False


def span(name: str, chunk=None, frames: int = 0):
    """A context manager that records span `name` while the recorder is
    on; `chunk` (else the enclosing span's) ties it to a chunk's work."""
    if not RECORDER.on:
        return _NO_SPAN
    return _Span(name, chunk, frames)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while the recorder is on."""
    if not RECORDER.on:
        return
    with RECORDER.lock:
        RECORDER.counters[name] = RECORDER.counters.get(name, 0) + n


def enable() -> None:
    RECORDER.on = True


def disable() -> None:
    RECORDER.on = False


def drain() -> tuple[list[SpanEvent], dict[str, int]]:
    """The events and counters recorded since the last drain; clears
    them."""
    with RECORDER.lock:
        events, RECORDER.events = RECORDER.events, []
        counters, RECORDER.counters = RECORDER.counters, {}
    return events, counters


class Perf:
    def __init__(self):
        self._frame = 0
        self._table: dict[int, dict[str, float]] = {}
        self._names: list[str] = []
        self._mem: dict[int, dict[str, int]] = {}
        self._t0 = time.monotonic()

    def set_frame(self, frame_id: int):
        self._frame = frame_id

    @contextmanager
    def span(self, name: str):
        t = time.monotonic()
        try:
            # the module's span: one event while the recorder is on
            with span(name):
                yield
        finally:
            self.add_ms(name, (time.monotonic() - t) * 1000.0)

    def add_ms(self, name: str, ms: float):
        row = self._table.setdefault(self._frame, {})
        row[name] = row.get(name, 0.0) + ms
        if name not in self._names:
            self._names.append(name)

    def register_memory(self, name: str, nbytes: int):
        row = self._mem.setdefault(self._frame, {})
        row[name] = row.get(name, 0) + int(nbytes)

    def elapsed_ms(self) -> float:
        return (time.monotonic() - self._t0) * 1000.0

    def write(self, path: str):
        """perf_time.csv: frame rows x function columns (Perf.cpp:145-172)."""
        with open(path, "w") as f:
            f.write("frame," + ",".join(self._names) + "\n")
            for frame in sorted(self._table):
                row = self._table[frame]
                f.write(str(frame) + "," + ",".join(
                    f"{row.get(n, 0.0):.3f}" for n in self._names) + "\n")

    def write_memory(self, path: str):
        names: list[str] = []
        for row in self._mem.values():
            for n in row:
                if n not in names:
                    names.append(n)
        with open(path, "w") as f:
            f.write("frame," + ",".join(names) + "\n")
            for frame in sorted(self._mem):
                row = self._mem[frame]
                f.write(str(frame) + "," + ",".join(
                    str(row.get(n, 0)) for n in names) + "\n")
