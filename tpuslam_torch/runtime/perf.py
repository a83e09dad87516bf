"""Named-span profiler.

Twin of the reference Perf (/root/reference/src/slam/src/core/Perf.cpp):
startTime/stopTime pairs accumulate per-frame x per-function milliseconds
into a table written as CSV (perf_time.csv), plus frame time-log markers.
Copied from tpuslam/runtime/perf.py.  Device work is timed host-side;
callers that need exact device timing end their spans with
`torch.cuda.synchronize()`.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


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
