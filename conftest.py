"""Guards for the tier-1 suite under tests/, kept apart from
tests/conftest.py (which sets JAX up on the CPU):

- one torch intra-op thread per process: the suite runs several xdist
  workers on the machine's cores, and more threads oversubscribe them;
- one persistent XLA compile cache per run, shared by the run's xdist
  workers, so a program that several files build compiles once; the
  session ends with one line of its hits and misses;
- a time limit, TIME_LIMIT, on each test's setup, call and teardown: past
  it the processes that the test started are killed, the stacks of all
  threads go into its report, and that test alone fails.  It bounds every
  wait inside a test;
- the `free_port` fixture: TCP ports that no two workers of a run share.

The thread count and the cache apply to runs that loaded tests/conftest.py:
slambench/tests must not load JAX, and the card runs its tests with
--noconftest.
"""

import faulthandler
import os
import signal
import socket
import tempfile
import threading
from pathlib import Path

import pytest

SUITE_CONFTEST = Path(__file__).resolve().parent / "tests" / "conftest.py"

# Seconds that each of a test's setup, call and teardown may take: twice
# the slowest phase of a whole run with 6 workers on 8 cores (~240 s) and
# more, since on half the cores the slowest phases pass 420 s.
TIME_LIMIT = 600


# ------------------------------------------------- one XLA compile cache

_CACHE_EVENTS = {"/jax/compilation_cache/compile_requests_use_cache":
                 "requests",
                 "/jax/compilation_cache/cache_hits": "hits"}
_CACHE_COUNTS = pytest.StashKey[dict]()


@pytest.hookimpl(trylast=True)
def pytest_configure(config):
    """In a run of the suite: one torch thread, and the persistent compile
    cache in a directory new to this run (the parent of an xdist worker's
    base temp is the run's own base temp, which all its workers share)."""
    if not config.pluginmanager.has_plugin(str(SUITE_CONFTEST)):
        return
    import jax
    import torch
    from tpuslam.runtime.cache import enable_persistent_cache
    torch.set_num_threads(1)
    base = config._tmp_path_factory.getbasetemp()
    if hasattr(config, "workerinput"):
        base = base.parent
    enable_persistent_cache(str(base / "xla-cache"))
    counts = config.stash[_CACHE_COUNTS] = dict(requests=0, hits=0)

    def count(event, **_):
        if event in _CACHE_EVENTS:
            counts[_CACHE_EVENTS[event]] += 1
    jax.monitoring.register_event_listener(count)


def pytest_sessionfinish(session):
    if hasattr(session.config, "workeroutput"):
        session.config.workeroutput["xla_cache"] = \
            session.config.stash.get(_CACHE_COUNTS, {})


@pytest.hookimpl(optionalhook=True)
def pytest_testnodedown(node, error):
    counts = node.config.stash.get(_CACHE_COUNTS, {})
    for k, v in getattr(node, "workeroutput", {}).get("xla_cache",
                                                      {}).items():
        counts[k] += v


def pytest_terminal_summary(terminalreporter, config):
    c = config.stash.get(_CACHE_COUNTS, None)
    if c is not None:
        terminalreporter.write_line(
            f"XLA compile cache: {c['hits']} hits, "
            f"{c['requests'] - c['hits']} misses in {c['requests']} compiles")


# ------------------------------------------------ a time limit per test

def _descendants(pid):
    """The processes that `pid` started, and theirs."""
    out = []
    for task in Path(f"/proc/{pid}/task").glob("*"):
        try:
            children = (task / "children").read_text().split()
        except OSError:                 # the task ended meanwhile
            continue
        for c in map(int, children):
            out += [c] + _descendants(c)
    return out


class _TimeLimit:
    """Arms SIGALRM for one phase of one test; on expiry kills the
    test's child processes and raises a test failure that carries the
    stacks of all threads."""

    def __init__(self, item, phase):
        self.where = f"{item.nodeid} ({phase})"

    def _expired(self, signum, frame):
        for pid in _descendants(os.getpid()):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        with tempfile.TemporaryFile() as f:
            faulthandler.dump_traceback(f, all_threads=True)
            f.seek(0)
            stacks = f.read().decode(errors="replace")
        raise pytest.fail.Exception(
            f"{self.where} ran past the {TIME_LIMIT} s limit; its child "
            f"processes were killed; the stacks of all threads:\n{stacks}",
            pytrace=False)

    def __enter__(self):
        # signals reach only the main thread, where xdist runs the tests
        self.armed = threading.current_thread() is threading.main_thread()
        if self.armed:
            self.old = signal.signal(signal.SIGALRM, self._expired)
            signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT)

    def __exit__(self, *exc):
        if self.armed:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, self.old or signal.SIG_DFL)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _TimeLimit(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _TimeLimit(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _TimeLimit(item, "teardown"):
        return (yield)


# ---------------------------------------------------------------- ports

_PORT_BASE, _PORTS_PER_WORKER = 20000, 100     # below the ephemeral range
_ports_given = {}


def take_port() -> int:
    """A free TCP port on localhost that no other xdist worker of the run
    hands out: worker gwN draws from its own range of ports, in turn, and
    passes over one that something else holds."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    base = _PORT_BASE + int(worker.removeprefix("gw")) * _PORTS_PER_WORKER
    for _ in range(_PORTS_PER_WORKER):
        n = _ports_given[worker] = _ports_given.get(worker, -1) + 1
        port = base + n % _PORTS_PER_WORKER
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in {base}-"
                       f"{base + _PORTS_PER_WORKER - 1}")


@pytest.fixture(scope="session")
def free_port():
    """`take_port`, for tests that start processes which meet on a port."""
    return take_port
