"""One camera stream: its log, its set-up, its measured window and the
check of what its timed path produced.

A stream renders its log on the card from the run's seed and its index
(slambench/world.py), writes it as KITTI PNG files under TMPDIR, builds
the program's `FastSlamPipeline` and warms it on one chunk, then replays
the log through `FastSlamPipeline.run_ingest` with a fresh `Mapper` (async
loop closure, device dictionary) until the window closes, each replay
after `reset()`.

The harness wraps three of the pipeline's calls, on the instance, as
spans: `dispatch` (the chunk driver and the VO step), `_consume` (the
results, the Mapper, the loop-closure thread's joins) and the chunk
generator `_ingest_chunks` (the wait for decoded and uploaded frames),
and, for SGBM, the front end's call of `sgbm`.
`_consume` returning stamps a chunk's completion and keeps what the timed
path produced for the check.  Once the window has closed, the next
`dispatch` raises `WindowClosed`: the chunks already queued are consumed,
the Mapper joins its loop closure, and the stream stops.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, logfiles, trace, world


# spans whose kernels' device time a trace keeps
ANNOTATED = ("sgbm",)


class WindowClosed(Exception):
    """Raised by the wrapped dispatch once the window has closed."""


@dataclass
class Replay:
    """What one replay of the log produced, chunk by chunk."""
    chunks: list = field(default_factory=list)   # (start, n, outs, feats)
    graph_poses: dict = field(default_factory=dict)
    loop_closures: int = 0


def slam_config(pipeline: dict):
    """The program's SlamConfig as a configuration file states it."""
    from tpuslam_torch import config as C
    return C.SlamConfig(
        depth_method=C.DepthMethod(pipeline["depth"]),
        fused_speckle=pipeline["speckle"],
        bm=C.StereoBMConfig(**pipeline["bm"]),
        sgbm=C.SGBMConfig(**pipeline["sgbm"]),
        gftt=C.GFTTConfig(**pipeline["gftt"]),
        orb=C.ORBConfig(edge_threshold=pipeline["orb"]["edge_threshold"]),
        mapper=C.MapperConfig(map_update=pipeline["map_update"]))


class Stream:
    def __init__(self, index: int, seed: int, config: dict, traffic: dict,
                 device: str = "cuda", faults=()):
        self.index = index
        self.seed = seed
        self.config = config
        self.traffic = traffic
        self.device = device
        self.faults = faults
        self.replays: list[Replay] = []
        self.spans: list = []            # (name, start_ns, end_ns, frames)
        self.completions: list = []      # (perf_counter s, frames)
        self.stop_at = None
        self.profiler = None           # the running profiler
        self.stopped = None            # the profiler stopped at the close
        self.trace_from = None
        self.trace_summary = None
        self.dir = None
        # perf_counter_ns -> the profiler's clock (ns since the epoch)
        self.clock_offset = time.time_ns() - time.perf_counter_ns()

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        marks = [time.perf_counter()]
        cam = self.config["camera"]
        log = self.traffic["log"]
        poses = world.forward_trajectory(self.config["sequence_frames"],
                                         log["speed_m"], log["yaw_rad"])
        left, right, self.gt = world.render_log(
            poses, world.world_seed(self.seed, self.index), cam["width"],
            cam["height"], cam["f"], cam["baseline"], self.device)
        self.left = left.cpu().numpy()
        self.right = right.cpu().numpy()
        del left, right
        marks.append(time.perf_counter())
        self.dir = tempfile.mkdtemp(prefix=f"slambench-{self.index}-")
        self.lpaths, self.rpaths, self.stamps, self.calib = \
            logfiles.write_kitti(self.dir, self.left, self.right, cam["f"],
                                 cam["baseline"],
                                 self.traffic["png_threads"])
        marks.append(time.perf_counter())

        from tpuslam_torch.geometry.camera import StereoCameraModel
        from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
        pl = self.config["pipeline"]
        self.cfg = slam_config(pl)
        self.camera = StereoCameraModel.load_kitti(
            self.calib, image_size=(cam["width"], cam["height"]))
        self.pipe = FastSlamPipeline(self.camera, self.cfg, chunk=pl["chunk"],
                                     capacity=pl["capacity"],
                                     device=self.device)
        self._wrap(self.pipe)
        marks.append(time.perf_counter())
        for fault in self.faults:
            fault(self.pipe)
        # one warm chunk with a throwaway Mapper: every kernel and shape
        # that the window runs
        n = pl["chunk"]
        self.pipe.reset()
        self.pipe.run_ingest(self.lpaths[:n], self.rpaths[:n],
                             self.stamps[:n], mapper=self._mapper())
        self.replays, self.spans, self.completions = [], [], []
        if self.device != "cpu":
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        took = np.diff(marks)
        print(f"# stream {self.index} set-up: render {took[0]:.2f} s, "
              f"PNG files {took[1]:.2f} s, program {took[2]:.2f} s, warm "
              f"chunk {took[3]:.2f} s", file=sys.stderr, flush=True)

    def _mapper(self):
        from tpuslam_torch.mapping.mapper import Mapper
        m = Mapper(self.camera, self.cfg.mapper, self.cfg.matching,
                   self.cfg.pnp, device=self.device)
        m.async_lc = self.config["pipeline"]["async_lc"]
        return m

    def _wrap(self, pipe) -> None:
        dispatch, consume = pipe.dispatch, pipe._consume
        chunks = pipe._ingest_chunks
        pc = time.perf_counter_ns

        def timed_dispatch(lefts, rights, stamps, n_active):
            now = time.perf_counter()
            if self.stop_at is not None and now >= self.stop_at:
                self._trace_stop()
                raise WindowClosed
            if self.trace_from is not None and now >= self.trace_from:
                self.trace_from = None
                self.profiler = trace.start(self.device)
                self.trace_start_ns = time.time_ns()
            t0 = pc()
            out = dispatch(lefts, rights, stamps, n_active)
            self.spans.append(("dispatch", t0, pc(), int(n_active)))
            return out

        def timed_consume(pending, gts, mapper):
            t0 = pc()
            out = consume(pending, gts, mapper)
            t1 = pc()
            self.spans.append(("consume", t0, t1, int(pending["n"])))
            self.completions.append((t1 / 1e9, int(pending["n"])))
            if self.replays:
                self.replays[-1].chunks.append(check.capture(pending))
            return out

        def timed_chunks(loader, stamps):
            it = chunks(loader, stamps)
            try:
                while True:
                    t0 = pc()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    self.spans.append(("ingest", t0, pc(), 0))
                    yield item
            finally:
                it.close()

        pipe.dispatch = timed_dispatch
        pipe._consume = timed_consume
        pipe._ingest_chunks = timed_chunks
        if self.config["pipeline"]["depth"] == "sgbm":
            # the fused front end calls its module's `sgbm` by name
            import tpuslam_torch.vo.fused as fused
            sgbm = fused.sgbm

            def annotated_sgbm(*args, **kwargs):
                t0 = pc()
                out = sgbm(*args, **kwargs)
                self.spans.append(("sgbm", t0, pc(), 0))
                return out

            fused.sgbm = annotated_sgbm

    # -- the window --------------------------------------------------------
    def run_window(self, t0: float, seconds: float, trace_from=None) -> None:
        """Replay the log back to back from perf_counter time t0 until
        t0 + seconds; with `trace_from` (perf_counter s), profile the card
        from the first dispatch after it to the first one after the
        window's close (the profiler starts and stops on the thread that
        dispatches, the one that registered it)."""
        from tpuslam_torch.kernels import _cuda
        self.stop_at = t0 + seconds
        self.trace_from = trace_from
        _cuda.reset_counters()
        if self.device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        while time.perf_counter() < self.stop_at:
            replay = Replay()
            self.replays.append(replay)
            self.pipe.reset()
            mapper = self._mapper()
            try:
                self.pipe.run_ingest(self.lpaths, self.rpaths, self.stamps,
                                     mapper=mapper)
            except WindowClosed:
                mapper.join_loop_closure()
            if replay.chunks:
                poses, links = mapper.get_graph()
                replay.graph_poses = {k: np.asarray(v) for k, v in
                                      poses.items()}
                replay.loop_closures = sum(
                    1 for _, lk in links.items() if lk.type == 1)
        self.peak_bytes = (torch.cuda.max_memory_allocated()
                           if self.device != "cpu" else 0)
        # the program's own counters: a kernel's plain twin on the card
        # would show here
        print(f"# stream {self.index} launches "
              f"{ {k: v for k, v in _cuda.LAUNCHES.items() if v} } plain "
              f"calls { {k: v for k, v in _cuda.PLAIN_CALLS.items() if v} }",
              file=sys.stderr, flush=True)
        self._trace_stop()
        if self.stopped is not None:
            self.trace_summary = trace.summarize(
                self.stopped, self.trace_start_ns, self.trace_stop_ns,
                [(n, a, b) for n, a, b, _ in self.span_ns()
                 if n in ANNOTATED])
            self.stopped = None

    def _trace_stop(self) -> None:
        if self.profiler is None:
            return
        self.trace_stop_ns = time.time_ns()
        self.profiler.stop()
        self.stopped, self.profiler = self.profiler, None

    # -- after the window --------------------------------------------------
    def free_program(self) -> None:
        """Drop the program's state before the reference runs."""
        self.pipe = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def close(self) -> None:
        """Remove the log's files."""
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)

    def span_ns(self):
        """Spans on the profiler's clock."""
        off = self.clock_offset
        return [(n, a + off, b + off, k) for n, a, b, k in self.spans]


def stream_seed_rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 63) - 1), index, 7])


def env_threads() -> None:
    """One intra-op thread for torch and the numeric libraries, before
    torch is imported."""
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(k, "1")
