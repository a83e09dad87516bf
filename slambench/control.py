"""The control of `correct`: the plain reference computed one precision
step down (slambench/reference/frontend.py, low=True) put in the
program's place, compared with the reference by the check's own
front-end numbers.  It has to fail them.

    python -m slambench.control --config kitti-bm --seeds 11 12 13
                                [--frames 6] [--device cuda]

renders stream 0's log of each seed at the configuration's own size,
takes `--frames` of its map-node frames drawn from the seed, as a run's
check does, and prints each seed's numbers and, last, the least reading
of each number over the seeds: the upper reading that a limit has to
stay below.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import torch

from . import check, logfiles, world
from .run import HERE, load_json
from .stream import stream_seed_rng


def readings(config: dict, log: dict, seed: int, frames: int,
             device) -> dict:
    cam = config["camera"]
    pl = config["pipeline"]
    poses = world.forward_trajectory(config["sequence_frames"],
                                     log["speed_m"], log["yaw_rad"])
    nodes = list(range(pl["map_update"] - 1, len(poses), pl["map_update"]))
    rng = stream_seed_rng(seed, 0)
    idx = sorted(rng.choice(nodes, size=min(frames, len(nodes)),
                            replace=False).tolist())
    left, right, _ = world.render_log(
        poses, world.world_seed(seed, 0), cam["width"], cam["height"],
        cam["f"], cam["baseline"], device, frames=idx)
    with tempfile.TemporaryDirectory() as d:
        calib = logfiles.write_calib(d, cam["width"], cam["height"],
                                     cam["f"], cam["baseline"])
        left, right = left.cpu().numpy(), right.cpu().numpy()
        want = check.reference_frontend(left, right, pl, calib, device)
        got = check.reference_frontend(left, right, pl, calib, device,
                                       low=True)
    return check.frontend_numbers(list(zip(got, want)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="single")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = load_json(HERE, "configs", f"{args.config}.json")
    log = load_json(HERE, "traffic", f"{args.traffic}.json")["log"]
    if args.device != "cpu" and not torch.cuda.is_available():
        print("slambench.control: no card", file=sys.stderr)
        return 3
    rows = []
    for seed in args.seeds:
        r = readings(config, log, seed, args.frames, args.device)
        rows.append(r)
        print(json.dumps(dict(config=args.config, seed=seed, **r)))
    least = {k: min(r[k] for r in rows) for k in rows[0]}
    print(json.dumps(dict(config=args.config, least=least,
                          limits={k: config["limits"][k] for k in least})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
