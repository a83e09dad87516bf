"""tpuslam_torch's span and counter recorder (runtime/perf.py): off it
records nothing and allocates nothing; on, spans nest per thread, counters
add up, and drain() hands everything out once.  Perf's CSV table emits
its spans as events too."""

import sys
import threading
import tracemalloc

import pytest

from tpuslam_torch.runtime import perf


@pytest.fixture(autouse=True)
def _recorder_off():
    perf.disable()
    perf.drain()
    yield
    perf.disable()
    perf.drain()


def test_off_records_nothing_and_allocates_nothing():
    assert not perf.RECORDER.on
    assert perf.span("a") is perf.span("b", chunk=(0, 3), frames=2)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with perf.span("a", chunk=(0, 3), frames=2):
                perf.count("c", 5)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == perf.__file__ and d.size_diff > 0]
    assert grown == []
    assert perf.drain() == ([], {})


def test_spans_nest_per_thread_across_two_threads():
    perf.enable()
    inside = threading.Barrier(2, timeout=30)
    ids = {}

    def work(tag):
        with perf.span("outer", chunk=(1, tag)):
            inside.wait()                   # both outers open at once
            with perf.span("inner", frames=tag):
                inside.wait()
        ids[tag] = threading.get_native_id()

    threads = [threading.Thread(target=work, args=(k,)) for k in (3, 6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    events, _ = perf.drain()
    assert len(events) == 4 and len({e.id for e in events}) == 4
    by_id = {e.id: e for e in events}
    for e in events:
        if e.name == "outer":
            assert e.parent == 0 and e.frames == 0
        else:
            up = by_id[e.parent]
            # its parent is its own thread's outer span; the chunk is
            # inherited from it
            assert up.name == "outer" and up.thread == e.thread
            assert e.chunk == up.chunk == (1, e.frames)
            assert up.start_ns <= e.start_ns <= e.end_ns <= up.end_ns
        assert e.thread == ids[e.chunk[1]]


def test_counters_and_spans_add_up_across_threads():
    """More threads than cores, switching often: no count and no span is
    lost."""
    perf.enable()

    def work():
        for _ in range(500):
            with perf.span("s"):
                perf.count("frames", 2)
        perf.count("chunks")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    events, counters = perf.drain()
    assert counters == {"frames": 16000, "chunks": 16}
    assert len(events) == 8000 and len({e.id for e in events}) == 8000


def test_drain_clears_and_a_span_open_at_disable_is_dropped():
    perf.enable()
    with perf.span("kept"):
        pass
    perf.count("n", 3)
    events, counters = perf.drain()
    assert [e.name for e in events] == ["kept"] and counters == {"n": 3}
    assert perf.drain() == ([], {})
    with perf.span("cut"):
        perf.disable()
    assert perf.drain() == ([], {})


def test_perf_table_spans_are_events_while_on(tmp_path):
    p = perf.Perf()
    with p.span("untraced"):
        pass
    perf.enable()
    with p.span("frontend"):
        with perf.span("kernel"):
            pass
    events, _ = perf.drain()
    assert [e.name for e in events] == ["kernel", "frontend"]
    assert events[0].parent == events[1].id
    p.write(str(tmp_path / "perf_time.csv"))
    assert (tmp_path / "perf_time.csv").read_text().splitlines()[0] == \
        "frame,untraced,frontend"
