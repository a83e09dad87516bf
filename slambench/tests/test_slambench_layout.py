"""BENCHMARK.json against the files it names, and the arithmetic of a
window, a trace and a roofline on synthetic inputs."""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest

from slambench import harness, roofline_peaks, run, window

ROOT = os.path.dirname(run.HERE)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    spec = run.resolve(BENCH, cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["name"] == spec["cell"]["traffic"]
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(run.load_module("metrics", m["name"]).read)
        assert m["moves"] in e2e


def test_names_and_files_follow_the_contract():
    names = ([c["name"] for c in BENCH["configs"]] +
             [w["name"] for w in BENCH["workloads"]] +
             [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("slambench/")
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in la and len(la) <= 200 for la in layers)


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4", "k5", "k6"])
def test_roofline_files(kernel):
    mod = run.load_module("roofline", kernel)
    assert set(mod.CALLS) <= set(mod.KERNELS)
    nbytes, ops = mod.cost(dict(frames=30, height=376, width=1241, ndisp=64,
                                capacity=1536, kpts_per_frame=1400.0))
    assert nbytes > 0 and ops > 0


def test_k1_bound_is_the_kernel_tables():
    mod = run.load_module("roofline", "k1")
    ms = roofline_peaks.least_ms(*mod.cost(dict(
        frames=30, height=376, width=1241, ndisp=64)))
    assert ms == pytest.approx(0.0802, abs=5e-5)


def test_rate_between_chunk_completions():
    # completions before the window and after it are out
    comps = [(0.5, 30), (1.0, 30), (2.0, 30), (3.0, 30), (4.0, 30),
             (5.5, 30)]
    assert window.rate(comps, 1.0, 5.0) == pytest.approx(90 / 3.0)
    assert window.rate([(1.0, 30)], 0.0, 5.0) is None
    other = [(1.5, 30), (2.5, 30), (4.5, 30)]
    assert window.fleet_rate([comps, other], 1.0, 5.0) == \
        pytest.approx(30.0 + 60 / 3.0)
    assert window.fleet_rate([comps, [(1.5, 30)]], 1.0, 5.0) is None


def test_span_ms_per_frame():
    spans = [("dispatch", 10, 20, 30), ("dispatch", 30, 60, 30),
             ("consume", 20, 25, 30), ("dispatch", 100, 200, 30),
             ("ingest", 0, 10, 0), ("ingest", 25, 30, 0)]
    assert window.span_ms_per_frame(spans, "dispatch", 0, 99) == \
        pytest.approx(40 / 1e6 / 60)
    assert window.span_ms_per_frame(spans, "ingest", 0, 99) == \
        pytest.approx(15 / 1e6 / 60)


def test_union_busy_and_gaps():
    iv = np.array([[0, 10], [5, 20], [30, 40], [35, 38], [50, 80]])
    assert window.busy_ns(iv, 0, 100) == 20 + 10 + 30
    assert window.busy_ns(iv, 8, 60) == 12 + 10 + 10
    assert window.gaps(iv, 0, 100).tolist() == [[80, 100], [20, 30],
                                                [40, 50]]
    spans = [("dispatch", 0, 26, 1), ("consume", 15, 46, 1),
             ("dispatch", 60, 70, 1)]
    assert window.idle_by_state(iv, 0, 100, spans) == [
        ["none", 20 / 1e9], ["consume", 10 / 1e9],
        ["consume+dispatch", 10 / 1e9]]


def _gathered(traces, spans=()):
    win = {i: dict(spans=list(spans), trace=t, kpts_per_frame=1400.0,
                   clock_offset=0, completions=[], peak_bytes=0, frames=0)
           for i, t in enumerate(traces)}
    return harness.Gathered(t0=0.0, setup_s=1.0, window=win, checks={},
                            modules=[])


def test_context_reads_idle_roofline_and_annotations():
    spec = dict(config=json.load(open(os.path.join(
        ROOT, "slambench/configs/kitti-bm.json"))))
    k1_ns = 1_380_000
    t = dict(start_ns=0, stop_ns=10_000_000,
             intervals=np.array([[0, 2_000_000], [1_000_000, 3_000_000]]),
             kernels={"bm_packed_kernel": [k1_ns - 72_000, 1],
                      "prefilter_kernel": [72_000, 1],
                      "at::native::elementwise_kernel": [500_000, 9]},
             annotated={"sgbm": [6_000_000, 2]})
    u = dict(t, start_ns=1_000_000, intervals=np.array([[5_000_000,
                                                         6_000_000]]))
    ctx = harness.Context(_gathered([t, u]), spec, 10.0)
    assert ctx.trace_lo == 1_000_000 and ctx.trace_hi == 10_000_000
    assert ctx.idle_pct() == pytest.approx(100 * (1 - 3 / 9))
    assert ctx.roofline(["k1"]) == pytest.approx(100 * 0.08021 / 1.38,
                                                 rel=1e-3)
    kernels = run.load_module("metrics", "kernels_roofline")
    assert kernels.KERNELS == ["k1", "k2", "k3", "k4", "k5", "k6"]
    assert kernels.read(ctx) == ctx.roofline(["k1"])
    assert ctx.roofline(["k2"]) is None
    assert ctx.annotated_ms_per_frame("sgbm") == pytest.approx(12 / 4 / 30)
    bd = harness.breakdown(ctx)
    assert bd["device_ops"][0][0] == "bm_packed_kernel"
    assert len(bd["idle_gaps"]) <= 10


def test_trace_base_names():
    from slambench.trace import base_name
    assert base_name("void bm_packed_kernel<7>(unsigned char const*, int)") \
        == "bm_packed_kernel"
    assert base_name("gftt_kernel(unsigned char const*, float*)") == \
        "gftt_kernel"
    assert base_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"
    assert base_name("(anonymous namespace)::lm_kernel(float const*)") == \
        "lm_kernel"
