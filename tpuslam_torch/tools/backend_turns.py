"""The device back end at KITTI 00's size, in this tree and in another
(a parent's, unpacked), in turns on one card.

    python -m tpuslam_torch.tools.backend_turns OTHER_TREE [--turns N]

Each turn is a process of its own, started from the root of its tree
(OTHER_TREE, this, this, OTHER_TREE; N times), that builds the
4541-vertex graph of chip_smoke.py's phase 14 (`kitti_size_graph`, from
tools/thomas_probe.py or, in an older tree, chip_smoke.py) and runs
`run_optimize_robust(backend="device")` on it three times: a cold run
(the kernels' build and first launches), then two warm ones, whose host
walls are kept, with K7's launches, and whose poses are compared bit
for bit.  Prints a line per turn and the medians; the last
line is one JSON object.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TURN = r"""
import json, time
import numpy as np, torch
try:
    from tpuslam_torch.tools.thomas_probe import kitti_size_graph
except ImportError:                     # a tree from before the probe
    from chip_smoke import kitti_size_graph
from tpuslam_torch.config import OptimizerConfig
from tpuslam_torch.kernels import _cuda
from tpuslam_torch.optim import pose_graph as PG
_, poses, links, _ = kitti_size_graph()
cfg = OptimizerConfig()
walls, outs, k7 = [], [], []
for _ in range(3):
    _cuda.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, chi2 = PG.run_optimize_robust(poses, links, cfg.final_iterations,
                                       cfg, backend="device")
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    outs.append((out, chi2))
    k7.append(_cuda.LAUNCHES["thomas"])
(a, ca), (b, cb) = outs[1:]
diff = max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
           for k in a)
print(json.dumps(dict(walls=walls, k7=k7, chi2=[float(ca), float(cb)],
                      bit_equal=diff == 0.0 and ca == cb, max_diff=diff)))
"""


def turn(tree):
    """One turn in `tree`: its JSON result."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    out = subprocess.run([sys.executable, "-c", TURN], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"back end turn in {tree} failed:\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def run(other, turns=1):
    """{"other": [...], "this": [...]} results, and their warm medians."""
    trees = {"other": Path(other).resolve(), "this": ROOT}
    res = {"other": [], "this": []}
    for _ in range(turns):
        for name in ("other", "this", "this", "other"):
            r = turn(trees[name])
            res[name].append(r)
            print(f"# back end at 4541 vertices, {name} ({trees[name]}): "
                  f"walls {[round(w, 4) for w in r['walls']]} s (cold, "
                  f"warm, warm), K7 launches {r['k7']}, the two warm runs "
                  f"bit for bit {r['bit_equal']} (max diff "
                  f"{r['max_diff']:.3e})", flush=True)
    med = {k: statistics.median(w for r in v for w in r["walls"][1:])
           for k, v in res.items()}
    print(f"# back end at 4541 vertices, warm medians: this {med['this']:.4f}"
          f" s, other {med['other']:.4f} s", flush=True)
    return dict(turns=res, median_s=med)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another tree's root, e.g. a parent's "
                    "unpacked archive")
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("backend_turns: needs a CUDA device")
    print(json.dumps(run(args.other, args.turns)))


if __name__ == "__main__":
    sys.exit(main())
