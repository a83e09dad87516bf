"""run_ingest against run_staged on the bench sequence, in turns, on the
card: is reading the frames from PNG files faster or slower than having
them staged on the card, and where does the host's time go in each?

    python -m tpuslam_torch.tools.ingest_turns [--turns N]

The bench sequence (bench.py:30-37: 120 frames of 1241x376) is rendered
on the card and written as PNGs (rows filtered as libpng filters them).
Then three ways of running bench.py's configuration (SlamConfig(), a
Mapper with async loop closure), each from a reset pipeline and a fresh
Mapper:

    staged       FastSlamPipeline.run_staged over the staged chunks, with
                 each frame's ground truth (as bench.py and chip_smoke.py
                 pass it)
    staged_nogt  the same without ground truth, as run_ingest runs
    ingest       FastSlamPipeline.run_ingest from the PNG files

One warm run of each, then N rounds, each running the three once in an
order rotated from round to round.  Per run: fps (host wall clock around
the run, ending in a synchronisation), and the host seconds the producer
spent in dispatch and the consumer in unpacking and the Mapper.  Last, the
median fps of each and the ratios to staged.  The host-bound loop's fps
spreads from run to run, so only these in-call medians compare the paths.
"""

from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from .probe_bm_parts import BENCH, CHUNK

CAPACITY = 1536
KINDS = ("staged", "staged_nogt", "ingest")


def write_bench_pngs(root: str, lefts: torch.Tensor, rights: torch.Tensor):
    """The frames as root/image_{0,1}/NNNNNN.png on 8 threads; returns the
    left and right paths."""
    from ..io import png
    paths = []
    jobs = []
    for sub, imgs in zip(("image_0", "image_1"), (lefts, rights)):
        os.makedirs(os.path.join(root, sub))
        host = imgs.cpu().numpy()
        ps = [os.path.join(root, sub, f"{i:06d}.png")
              for i in range(len(host))]
        paths.append(ps)
        jobs += list(zip(ps, host))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda pi: png.write_png(*pi), jobs))
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ingest_turns: needs a CUDA device")
    import tpuslam_torch  # noqa: F401  (applies the precision pin)
    from ..config import SlamConfig
    from ..io.synthetic import make_sequence, sequence_camera
    from ..mapping.mapper import Mapper
    from ..runtime.fast_pipeline import FastSlamPipeline

    cfg = SlamConfig()
    lefts, rights, stamps, gt = make_sequence(**BENCH)
    n = BENCH["n_frames"]
    camera = sequence_camera(BENCH["width"], BENCH["height"], BENCH["f"],
                             BENCH["baseline"])
    items = [dict(left=lefts[i], right=rights[i], stamp=stamps[i],
                  ground_truth=gt[i]) for i in range(n)]
    no_gt = [dict(it, ground_truth=None) for it in items]
    pipe = FastSlamPipeline(camera, cfg, chunk=CHUNK, capacity=CAPACITY,
                            seed=BENCH["seed"])
    staged = pipe.stage_chunks(items)
    spent = {"dispatch": 0.0, "consume": 0.0}

    def timed(name, fn):
        def wrapper(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapper

    pipe.dispatch = timed("dispatch", pipe.dispatch)
    pipe._consume = timed("consume", pipe._consume)
    fps = {k: [] for k in KINDS}
    with tempfile.TemporaryDirectory() as root:
        paths = write_bench_pngs(root, lefts, rights)

        def run(kind, record=True):
            pipe.reset()
            mp = Mapper(camera, cfg.mapper, cfg.matching, cfg.pnp)
            mp.async_lc = True
            spent.update(dispatch=0.0, consume=0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "ingest":
                pipe.run_ingest(*paths, stamps, mapper=mp)
            else:
                pipe.run_staged(staged, items if kind == "staged" else no_gt,
                                mapper=mp, mapper_async=True)
            torch.cuda.synchronize()
            f = n / (time.perf_counter() - t0)
            if record:
                fps[kind].append(f)
            print(f"{kind:12s} {f:.3f} fps; dispatch {spent['dispatch']:.2f}"
                  f" s, consume {spent['consume']:.2f} s"
                  f"{'' if record else ' (warm)'}", flush=True)

        for kind in KINDS:
            run(kind, record=False)
        for t in range(args.turns):
            for k in range(len(KINDS)):
                run(KINDS[(t + k) % len(KINDS)])
    med = {k: statistics.median(v) for k, v in fps.items()}
    print("medians: " + ", ".join(f"{k} {v:.3f}" for k, v in med.items()) +
          "; ratios to staged: " + ", ".join(
              f"{k} {med[k] / med['staged']:.4f}" for k in KINDS[1:]) +
          f"; spread of all runs {min(map(min, fps.values())):.3f}-"
          f"{max(map(max, fps.values())):.3f} fps")
    return med


if __name__ == "__main__":
    main()
