"""The readings of the program's spans (slambench/spans.py) on synthetic
spans and a synthetic trace, and a traced run of the span probe on the
CPU at a small size."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from slambench import harness, span_probe, spans, stream, window
from slambench.spans import Span
from slambench.tests.test_slambench_run_cpu import SEED, small_spec

# producer (thread 1): two chunks, each a front end and two steps with
# their parts, a dictionary update and the fetch; consumer (thread 2)
PROGRAM = [
    Span("pipe.dispatch", 100, 200, 1, 0, 1, (0, 0), 2),
    Span("vo.frontend", 102, 130, 2, 1, 1, (0, 0), 0),
    Span("fe.disparity", 103, 110, 3, 2, 1, (0, 0), 0),
    Span("vo.step", 130, 160, 4, 1, 1, (0, 0), 0),
    Span("vo.match", 131, 140, 5, 4, 1, (0, 0), 0),
    Span("vo.ransac", 140, 155, 6, 4, 1, (0, 0), 0),
    Span("vo.step", 160, 190, 7, 1, 1, (0, 0), 0),
    Span("dict.dispatch", 190, 196, 8, 1, 1, (0, 0), 0),
    Span("pipe.fetch", 196, 199, 9, 1, 1, (0, 0), 0),
    Span("ingest.next", 200, 210, 10, 0, 1, None, 0),
    Span("pipe.dispatch", 210, 290, 11, 0, 1, (0, 2), 1),
    Span("vo.step", 212, 240, 14, 11, 1, (0, 2), 0),
    Span("pipe.consume", 150, 260, 12, 0, 2, (0, 0), 2),
    Span("consume.wait", 150, 240, 13, 12, 2, (0, 0), 0),
]


def test_host_ms_and_the_split():
    # both dispatches lie in [0, 300]: 3 frames
    assert spans.frames(PROGRAM, 0, 300) == 3
    assert spans.frames(PROGRAM, 0, 250) == 2
    assert spans.host_ms_per_frame([PROGRAM], ("vo.step",), 0, 300) == \
        pytest.approx(88 / 1e6 / 3)
    assert spans.host_ms_per_frame([PROGRAM], ("ingest.next", "vo.match"),
                                   0, 300) == pytest.approx(19 / 1e6 / 3)
    # the second dispatch leaves [0, 250]: its vo.step, inside, is not
    # counted with the first's frames
    assert spans.host_ms_per_frame([PROGRAM], ("vo.step",), 0, 250) == \
        pytest.approx(60 / 1e6 / 2)
    assert spans.host_ms_per_frame([PROGRAM], ("vo.step",), 400, 500) \
        is None
    split = spans.dispatch_split([PROGRAM], 0, 300)
    assert split["pipe.dispatch"] == pytest.approx(180 / 1e6 / 3)
    # pipe.dispatch outside its children: 100 - (28 + 30 + 30 + 6 + 3),
    # and 80 - 28 of the second
    assert split["self"] == pytest.approx((3 + 52) / 1e6 / 3)
    assert split["covered"] == pytest.approx(1 - 55 / 180)
    # streams number their spans alike: each is read on its own
    assert spans.dispatch_split([PROGRAM, PROGRAM], 0, 300) == \
        pytest.approx(split)


def test_innermost_is_the_deepest_then_the_latest():
    t = np.array([105, 135, 145, 152, 165, 205, 250, 295])
    names, code = spans.innermost(PROGRAM, t)
    got = [names[c] if c >= 0 else None for c in code]
    # 152: vo.ransac (depth 2) over consume.wait (depth 1); 165: vo.step
    # and consume.wait both at depth 1, vo.step began later; 205:
    # consume.wait over ingest.next (depth 0); 250: pipe.dispatch and
    # pipe.consume at depth 0, pipe.dispatch began later
    assert got == ["fe.disparity", "vo.match", "vo.ransac", "vo.ransac",
                   "vo.step", "consume.wait", "pipe.dispatch", None]


def test_idle_by_span_shares_a_gap_among_the_streams():
    iv = np.array([[0, 100], [300, 400]])
    other = [Span("vo.refine", 0, 400, 1, 0, 7, None, 0)]
    harness_spans = [("dispatch", 250, 260, 0)]
    got = dict(spans.idle_by_span(iv, 0, 400, [(PROGRAM, harness_spans),
                                               (other, [])]))
    # one gap [100, 300], middle 200: stream 0 is in consume.wait there
    assert got == pytest.approx({"consume.wait": 100 / 1e9,
                                 "vo.refine": 100 / 1e9})
    # a stream with no program span open leaves the gap to the others
    got = dict(spans.idle_by_span(iv, 0, 400, [(other, []),
                                               ([], harness_spans)]))
    assert got == pytest.approx({"vo.refine": 200 / 1e9})
    # where no stream has a program span open, the harness's names, as
    # window.idle_by_state gives them
    iv = np.array([[0, 500], [520, 600], [650, 700]])
    hs = [("dispatch", 505, 515, 0), ("ingest", 500, 700, 0)]
    prog = [Span("vo.match", 620, 640, 1, 0, 7, None, 0)]
    got = dict(spans.idle_by_span(iv, 0, 700, [(prog, hs)]))
    assert got == pytest.approx({"dispatch+ingest": 20 / 1e9,
                                 "vo.match": 50 / 1e9})
    assert got["dispatch+ingest"] == dict(window.idle_by_state(
        np.array([[0, 500], [520, 700]]), 0, 700, hs))["dispatch+ingest"]


def test_counter_readings_rates_and_the_frames_check():
    counters = {"ingest.frames": 90, "ingest.bytes": 90 * 1000,
                "dict.nodes": 12, "pipe.chunks": 4, "pipe.frames": 5}
    got = spans.counter_readings(counters, [PROGRAM], 3.0)
    assert got == pytest.approx(dict(
        decode_fps=30.0, upload_mb_s=0.03, upload_bytes_per_frame=1000.0,
        dict_nodes_per_chunk=3.0, frames_counted=5, frames_in_spans=3,
        chunks_counted=4, chunks_in_spans=2))
    empty = spans.counter_readings({}, [], 1.0)
    assert empty["upload_bytes_per_frame"] is None
    assert empty["dict_nodes_per_chunk"] is None
    assert empty["frames_counted"] == empty["frames_in_spans"] == 0


class _Event:
    def __init__(self, dev, start, dur, corr):
        self.dev, self.start, self.dur, self.corr = dev, start, dur, corr

    def device_type(self):
        return "DeviceType.CUDA" if self.dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr


class _Prof:
    """What trace_reading reads of a stopped torch profiler."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_trace_reading_counts_launches_by_span():
    ev = [  # runtime calls (host) and the operations they launched
        _Event(False, 105, 2, 1), _Event(True, 300, 10, 1),
        _Event(False, 145, 2, 2), _Event(True, 320, 30, 2),
        _Event(False, 192, 2, 3), _Event(True, 360, 5, 3),
        _Event(False, 205, 2, 4), _Event(True, 400, 7, 4),
        _Event(False, 295, 2, 5), _Event(True, 500, 4, 5),
        _Event(False, 296, 2, 6),   # a call that launched nothing
        _Event(True, 600, 9, 0)]    # an operation with no launch call
    got = spans.trace_reading(_Prof(ev), 0, 1000, PROGRAM)
    assert got["by_span"]["pipe.dispatch"] == [10 + 30 + 5, 3]
    assert got["by_span"]["vo.ransac"] == [30, 1]
    assert got["by_span"]["dict.dispatch"] == [5, 1]
    assert got["by_span"]["ingest.next"] == [7, 1]
    assert got["calls"] == 6 and got["unattributed"] == 2
    assert got["frames"] == 3
    # the window counts the calls that start in it
    assert spans.trace_reading(_Prof(ev), 150, 250, PROGRAM)["calls"] == 2


def test_clock_offset_puts_perf_counter_on_the_epoch():
    off = spans.clock_offset()
    assert abs(time.perf_counter_ns() + off - time.time_ns()) < 50_000_000
    moved = spans.shifted(PROGRAM[:1], 7)[0]
    assert (moved.start, moved.end, moved.name) == (107, 207,
                                                    "pipe.dispatch")


@pytest.fixture
def _probe_streams(monkeypatch):
    monkeypatch.setattr(stream, "Stream", span_probe.ProbeStream)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_probe_traced_run_on_the_cpu(_probe_streams):
    """The probe's stream records the program's spans over the window and
    the report splits pipe.dispatch into the parts that hold it."""
    spec = small_spec()
    # a chunk takes seconds here: the trace starts at the second, after
    # half the window
    seconds = 12.0
    t = time.perf_counter()
    g = harness._run_local(spec, SEED, seconds, True, t, device="cpu")
    res = harness.run(spec, SEED, seconds, True, t, gathered=g)
    assert res["correct"], res["checks"]
    prog = g.window[0]["trace"]["program"]
    assert prog["counters"]["pipe.frames"] >= 10
    assert prog["frames"] >= 5
    rep = span_probe.report(g, spec, seconds)
    split = rep["split"]
    assert split["covered"] > 0.9
    assert split["vo.step"] > split["vo.ransac"] > 0
    for name in spans.HOST_MS:
        assert rep["metrics"][name + ".stream"] is not None
    # the counters' frames are the recorded dispatches' but for the chunk
    # open at each edge of the window (a chunk is 5 frames here)
    c = rep["counters"]
    assert 0 <= c["frames_counted"] - c["frames_in_spans"] <= 2 * 5
    assert 0 <= c["chunks_counted"] - c["chunks_in_spans"] <= 2
    assert c["decode_fps"] > 0 and c["dict_nodes_per_chunk"] > 0
