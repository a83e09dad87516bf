"""Faults planted in the timed path, for the readings that a limit of
`correct` is set against: each breaks the program's chunk step
(`FastSlamPipeline._step`) on the instance, after its set-up.

    python -m slambench.faults --workload bm-drive --seed 11 --seconds 40
                               --fault pose_unchanged

runs a cell's stream 0 in this process with the fault and prints the
checks (the benchmark's runs never plant one).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def pose_unchanged(pipe):
    """The VO step hands back its state unchanged: every pose of a chunk
    stays at the pose it started from."""
    step = pipe._step

    def frozen(carry, *args):
        new, outs, feats = step(carry, *args)
        outs["pose"] = carry["pose"].expand_as(outs["pose"]).clone()
        return new, outs, feats
    pipe._step = frozen


def half_batch_left_out(pipe):
    """The second half of every chunk's frames never reaches the step."""
    step = pipe._step

    def half(carry, lefts, rights, *args):
        lefts, rights = lefts.clone(), rights.clone()
        lefts[lefts.shape[0] // 2:] = 0
        rights[rights.shape[0] // 2:] = 0
        return step(carry, lefts, rights, *args)
    pipe._step = half


def answer_altered(pipe):
    """One decimated disparity value of each map node altered where it
    is made."""
    step = pipe._step

    def altered(carry, *args):
        new, outs, feats = step(carry, *args)
        feats["disp_dec"][:, 10, 10] += 16
        return new, outs, feats
    pipe._step = altered


def reference_loads_jax(pipe):
    """Not a fault of the answers: the check's reference, run once the
    window has closed, loads a module named `jax` in this process, as a
    reference that called the JAX package would.  The run must then give
    no result."""
    from . import check
    numbers = check.stream_numbers

    def with_jax(*args, **kwargs):
        import types
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return numbers(*args, **kwargs)
    check.stream_numbers = with_jax


FAULTS = {f.__name__: f for f in (pose_unchanged, half_batch_left_out,
                                  answer_altered)}


def main(argv=None) -> int:
    from . import harness, run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), required=True)
    args = ap.parse_args(argv)
    spec = run.resolve(run.load_json("BENCHMARK.json"), args.workload)
    spec["traffic"] = dict(spec["traffic"], streams=1)
    t = time.perf_counter()
    g = harness._run_local(spec, args.seed, args.seconds, False, t,
                           faults=(FAULTS[args.fault],))
    res = harness.run(spec, args.seed, args.seconds, False, t, gathered=g)
    print(json.dumps(dict(fault=args.fault, correct=res["correct"],
                          checks=res["checks"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
