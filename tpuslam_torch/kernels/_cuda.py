"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

Each `.cu` file exports plain `extern "C"` launchers that return
`cudaGetLastError()` as an int.  It is compiled by nvcc into its own
shared library at first use and loaded with ctypes; no PyTorch headers are
compiled, so a build takes seconds.  Libraries go to
`build/tpuslam_torch/<hash>/` beside the package, keyed by a hash of the
source and flags, so a changed source rebuilds and an unchanged one is
reused.  A launcher is named like its kernel; SOURCES maps the launchers
that live in another kernel's file to that file.

KERNELS are the kernels of the main path; TOOLS are launchers that the
main path does not run: the K1 phase harness of
tpuslam_torch/tools/probe_bm_parts.py, and K3's two halves alone
(`orb_blur`, `orb_tests`), whose plain twins are the two halves of K3's
(counted as K3's plain version when it runs them).  The blur alone runs
on the tool apps' path and the multi-device front end: dist/mesh.py's
frontend_one, which the hardware self-test drives, and
sharded_frontend_step.
BACKEND are the kernels of the pose graph's device back end
(optim/device.py), which only `backend="device"` and dist/mesh.py's
sharded sparse step run: K7, the block-Thomas solve (`thomas`).

Counters: every kernel wrapper adds one to LAUNCHES[name] where it launches
its kernel; every plain PyTorch twin adds one to PLAIN_CALLS[name].  A run
can thus show which path it took.

Dispatch (`on_kernel`): a CUDA tensor goes to its kernel unless its
configuration lies outside what the kernel was built for; then the plain
version runs on the card, where tpuslam's own dispatch takes its XLA path
too (GFTT at a block size other than K2's 3).  The choice is made from the
configuration before any launch: a failed build or launch inside the
envelope raises.  K1 takes every StereoBM configuration (in its packed or
its wide kernel), as the reference's strip kernel does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpuslam_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# per-file extra flags: the float kernels must keep the plain version's
# f32 operation order, so FMA contraction is off for them
EXTRA_FLAGS = {"gftt": ["-fmad=false"], "orb": ["-fmad=false"],
               "thomas": ["-fmad=false"]}
KERNELS = ("stereo_bm", "gftt", "orb", "median", "lr_check", "lm_refine")
TOOLS = ("stereo_bm_phase", "orb_blur", "orb_tests")
BACKEND = ("thomas",)
ALL = KERNELS + TOOLS + BACKEND
# launcher name -> csrc/<source>.cu, where the two differ
SOURCES = {"stereo_bm_phase": "stereo_bm", "orb_blur": "orb",
           "orb_tests": "orb"}

# C signature of each launcher: pointers and the stream are
# void*, sizes and parameters int; every launcher returns cudaGetLastError()
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "stereo_bm": ("tpuslam_stereo_bm", [_P] * 6 + [_I] * 10 + [_P]),
    "gftt": ("tpuslam_gftt", [_P] * 3 + [_I] * 3 + [_P]),
    "orb": ("tpuslam_orb", [_P] * 7 + [_I] * 4 + [_P]),
    "median": ("tpuslam_masked_median2", [_P] * 5 + [_I] * 2 + [_P]),
    "lr_check": ("tpuslam_lr_check", [_P] * 3 + [_I] * 6 + [_P]),
    "lm_refine": ("tpuslam_lm_refine", [_P] * 9 + [_I] * 2 + [_P]),
    "stereo_bm_phase": ("tpuslam_stereo_bm_phase", [_P] * 6 + [_I] * 9 +
                        [_P]),
    "orb_blur": ("tpuslam_orb_blur", [_P] * 3 + [_I] * 3 + [_P]),
    "orb_tests": ("tpuslam_orb_tests", [_P] * 5 + [_I] * 4 + [_P]),
    "thomas": ("tpuslam_thomas", [_P] * 7 + [_I] * 2 + [_P]),
}

LAUNCHES = {k: 0 for k in ALL}
PLAIN_CALLS = {k: 0 for k in ALL}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def source(name: str) -> str:
    """The csrc/<source>.cu file that holds launcher `name`."""
    return SOURCES.get(name, name)


def _lib_path(name: str) -> Path:
    """The library of csrc/<name>.cu, keyed by its source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
    h = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_ROOT / h / f"lib{name}.so"


def build_all(names=ALL) -> dict[str, float]:
    """Compile the missing libraries of the launchers `names` in parallel;
    returns the seconds each source's build took (0.0 where its library
    was already built)."""
    procs, took = {}, {}
    for name in dict.fromkeys(source(n) for n in names):
        out = _lib_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = ([_nvcc()] + NVCC_FLAGS + EXTRA_FLAGS.get(name, []) +
               ["-o", str(tmp), str(CSRC / f"{name}.cu")])
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    for name, (p, tmp, out, t0) in procs.items():
        log, _ = p.communicate()
        took[name] = time.perf_counter() - t0
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                               f"{log.decode(errors='replace')}")
        os.replace(tmp, out)
    return took


def build_versions(src: str, versions) -> dict:
    """{name: (library, ptxas report, path)} of each (name, .cu path) in
    `versions`, versions of csrc/<src>.cu built in parallel with its flags
    and `-Xptxas -v` into build/tpuslam_torch/<src>_probe/, for a tool
    that times them in turns.  The report: per kernel (its mangled name)
    registers, shared memory bytes, spill store and load bytes."""
    out_dir = BUILD_ROOT / f"{src}_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in versions:
        out = out_dir / f"lib{name}.so"
        cmd = ([_nvcc()] + NVCC_FLAGS + EXTRA_FLAGS.get(src, []) +
               ["-Xptxas", "-v", "-o", str(out), str(path)])
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), out)
    built = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        report = {}
        for block in re.split(r"ptxas info\s*: Compiling entry function",
                              log)[1:]:
            kern = re.match(r"\s*'([^']+)'", block).group(1)
            nums = {key: re.search(pat, block) for key, pat in (
                ("registers", r"Used (\d+) registers"),
                ("smem", r"(\d+) bytes smem"),
                ("spill_stores", r"(\d+) bytes spill stores"),
                ("spill_loads", r"(\d+) bytes spill loads"))}
            report[kern] = {k: int(v.group(1)) if v else 0
                            for k, v in nums.items()}
        built[name] = (ctypes.CDLL(str(out)), report, out)
    return built


def library(src: str) -> ctypes.CDLL:
    """csrc/<src>.cu's library, built and loaded on first use."""
    with _lock:
        if src not in _libs:
            build_all((src,))
            _libs[src] = ctypes.CDLL(str(_lib_path(src)))
        return _libs[src]


def function(src: str, sym: str, argtypes):
    """The C function `sym` of csrc/<src>.cu's library, typed with
    `argtypes` and returning int."""
    fn = getattr(library(src), sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launcher(name: str):
    """The typed C launcher `name`."""
    if name not in _fns:
        _fns[name] = function(source(name), *SIGNATURES[name])
    return _fns[name]


def launch(name: str, *args) -> None:
    """Call kernel `name`'s launcher on the current stream of the current
    device (tensors become their data pointers) and count the launch;
    raise if the launch failed."""
    rc = launcher(name)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                          else a for a in args],
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1


def attributes(src: str, sym: str, n: int, *ints) -> tuple:
    """The n ints that csrc/<src>.cu's query `sym(*ints, int* out)` writes
    (attributes of a kernel: registers, shared memory, ...); raise on an
    error."""
    out = (ctypes.c_int * n)()
    rc = function(src, sym, [ctypes.c_int] * len(ints) + [ctypes.c_void_p])(
        *ints, out)
    if rc != 0:
        raise RuntimeError(f"{sym}: cudaError {rc}")
    return tuple(out)


def on_kernel(t: torch.Tensor, refusal) -> bool:
    """Whether a dispatcher sends `t` to its kernel: a CUDA tensor whose
    configuration the kernel takes (`refusal`, the kernel's reason to
    refuse the configuration, is None).  Any other tensor takes the plain
    version, on its own device."""
    return t.is_cuda and refusal is None


def expect(t: torch.Tensor, what: str, dtype: torch.dtype,
           ndim: int) -> None:
    """Argument check shared by the wrappers: CUDA, dtype, rank,
    contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
