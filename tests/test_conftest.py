"""The suite's guards in the repo's root conftest.py: the time limit on
each test, the compile cache of a run, and the ports of the tests that
start processes."""

import socket
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

ROOT_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"

THROWAWAY_CONFTEST = """
import importlib.util

spec = importlib.util.spec_from_file_location("guards", {path!r})
guards = importlib.util.module_from_spec(spec)
spec.loader.exec_module(guards)
guards.TIME_LIMIT = 2
pytest_runtest_setup = guards.pytest_runtest_setup
pytest_runtest_call = guards.pytest_runtest_call
pytest_runtest_teardown = guards.pytest_runtest_teardown
"""

THROWAWAY_TESTS = """
import subprocess
import sys
import time

import pytest


@pytest.fixture
def slow_setup():
    time.sleep(60)


@pytest.fixture
def slow_teardown():
    yield
    time.sleep(60)


def test_call_runs_over():
    time.sleep(60)


def test_setup_runs_over(slow_setup):
    pass


def test_teardown_runs_over(slow_teardown):
    pass


def test_child_runs_over():
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(60)"])
    with open("child.pid", "w") as f:
        f.write(str(p.pid))
    p.communicate()


def test_after():
    pass
"""


@pytest.fixture(scope="module")
def guards(request):
    """The root conftest.py, as pytest loaded it."""
    return request.config.pluginmanager.get_plugin(str(ROOT_CONFTEST))


@pytest.fixture(scope="module")
def over_limit_run(tmp_path_factory):
    """The time-limit hooks, cut to 2 s, around a file whose tests sleep
    60 s in their call, setup and teardown or wait on a child that does;
    (seconds the run took, {test name: [(outcome, text)]}, its folder)."""
    d = tmp_path_factory.mktemp("over_limit")
    (d / "conftest.py").write_text(
        THROWAWAY_CONFTEST.format(path=str(ROOT_CONFTEST)))
    (d / "test_sleeps.py").write_text(THROWAWAY_TESTS)
    t0 = time.monotonic()
    subprocess.run([sys.executable, "-m", "pytest", "-q", "-p",
                    "no:cacheprovider", "-p", "no:xdist", "-p",
                    "no:randomly", "--junitxml=report.xml"], cwd=d,
                   capture_output=True, timeout=120)
    took = time.monotonic() - t0
    results = {}
    for case in ET.parse(d / "report.xml").getroot().iter("testcase"):
        results[case.get("name")] = [
            (child.tag, (child.get("message") or "") + (child.text or ""))
            for child in case if child.tag in ("failure", "error",
                                               "skipped")]
    return took, results, d


@pytest.mark.parametrize("name, phase, outcome, frame", [
    ("call", "call", "failure", "test_call_runs_over"),
    ("setup", "setup", "error", "slow_setup"),
    ("teardown", "teardown", "error", "slow_teardown"),
    ("child", "call", "failure", "test_child_runs_over")])
def test_time_limit_fails_one_test_with_its_stacks(over_limit_run, name,
                                                   phase, outcome, frame):
    """A test past the limit in its `phase` fails alone, well before its
    sleep would end, and its report carries the stacks of all threads
    with the waiting frame; the test after it in the file passes."""
    took, results, _ = over_limit_run
    assert took < 50
    (got, text), = results[f"test_{name}_runs_over"]
    assert got == outcome
    assert f"test_{name}_runs_over ({phase}) ran past the 2 s limit" in text
    assert "(most recent call first)" in text and f"in {frame}" in text
    assert results["test_after"] == []


def test_time_limit_kills_the_tests_child(over_limit_run):
    """The child that a test past its limit waits on is killed."""
    _, _, d = over_limit_run
    stat = Path(f"/proc/{(d / 'child.pid').read_text()}/stat")
    if stat.exists():                   # not reaped yet: it must be dead
        assert stat.read_text().rsplit(")", 1)[1].split()[0] == "Z"


def test_compile_cache_is_the_runs_own(guards, request, tmp_path_factory):
    """The run's compile cache sits in the run's base temp (shared by its
    xdist workers), and each compile request is counted."""
    import jax
    from tpuslam.runtime import cache
    base = tmp_path_factory.getbasetemp()
    here = Path(jax.config.jax_compilation_cache_dir)
    assert here in (base / "xla-cache", base.parent / "xla-cache")
    assert here.is_dir() and cache._DONE
    counts = request.config.stash[guards._CACHE_COUNTS]
    before = counts["requests"]
    jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7.0)).block_until_ready()
    assert counts["requests"] > before


def test_free_port_gives_workers_disjoint_ports(guards, free_port,
                                                monkeypatch):
    """Six xdist workers of one run, each asking for ports in turn, are
    never handed the same one: each draws from its own range."""
    given = {}
    for w in range(6):
        monkeypatch.setenv("PYTEST_XDIST_WORKER", f"gw{w}")
        given[w] = [free_port() for _ in range(5)]
    for w, ports in given.items():
        lo = guards._PORT_BASE + w * guards._PORTS_PER_WORKER
        assert all(lo <= p < lo + guards._PORTS_PER_WORKER for p in ports)
    every = sum(given.values(), [])
    assert len(set(every)) == len(every)


def test_free_port_passes_over_a_held_port(guards, free_port, monkeypatch):
    """A port that another program holds is not handed out."""
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw3")
    free_port()
    lo, n = guards._PORT_BASE + 3 * guards._PORTS_PER_WORKER, \
        guards._ports_given["gw3"]
    with socket.socket() as held:
        held.bind(("localhost", lo + (n + 1) % guards._PORTS_PER_WORKER))
        held.listen()
        assert free_port() == lo + (n + 2) % guards._PORTS_PER_WORKER
