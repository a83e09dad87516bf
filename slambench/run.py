"""The benchmark of tpuslam_torch, driven by BENCHMARK.json.

    python -m slambench.run --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

run from the root of a checkout that holds BENCHMARK.json, slambench/ and
the program.  A cell names a configuration (slambench/configs/<name>.json)
and a traffic mix (slambench/traffic/<name>.json); its per-layer metrics
are read by slambench/metrics/<name>.py and the kernels' rooflines by
slambench/roofline/<kernel>.py, each found by name.

Set-up (timed as setup_s): the streams' logs rendered on the card and
written as PNG files, the program built and warmed on one chunk a stream.
Then every stream replays its log for --seconds; a traffic mix of more
than one stream runs each in a worker process of its own, held at a
barrier after its set-up, as a user runs one SLAM process per camera.
With --trace 1 the card is profiled over a part of the window and the
per-layer metrics are printed instead of the end-to-end ones.  Once the
window has closed and the program's state is freed, each stream checks
what its timed path produced (slambench/check.py).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, (with --trace 1) breakdown, and checks, each
compared number with its limit.  A run exits with another code than 0,
and prints no result, without a card, outside a checkout that holds the
program, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuslam")


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: tpuslam_torch is not tpuslam)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """slambench/<kind>/<name>.py, loaded by its path (names hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"slambench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str) -> dict:
    """The cell's configuration, traffic and metrics, each from its own
    file."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(conf["file"])
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not os.path.exists("BENCHMARK.json"):
        print("slambench: run it from the root of a checkout that holds "
              "BENCHMARK.json", file=sys.stderr)
        return 2
    spec = resolve(load_json("BENCHMARK.json"), args.workload)

    from .stream import env_threads
    env_threads()
    # the program builds its kernels into build/ of the checkout; any
    # extension or Triton cache goes there too, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(os.getcwd(), "build", sub))
    import torch
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import tpuslam_torch  # noqa: F401
    except ImportError as e:
        print(f"slambench: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 4
    torch.set_num_threads(1)
    from . import harness
    streams = spec["traffic"]["streams"]
    print(f"# device {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{power_limit()}; streams {streams}; cell {args.workload} "
          f"seed {args.seed} seconds {args.seconds} trace {args.trace}",
          file=sys.stderr)
    try:
        result = harness.run(spec, args.seed, args.seconds,
                             bool(args.trace), T_START)
    except harness.StreamFailed as e:
        print(f"slambench: {e}", file=sys.stderr)
        return 1
    found = foreign_modules()
    if found:
        print(f"slambench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 5
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    for name, value, op, limit in result.pop("_rows"):
        print(f"# check {name} {value} {op} {limit}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
