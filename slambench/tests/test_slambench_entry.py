"""The entry point refuses to run where it must, and nothing that it
loads is JAX or the JAX package."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch

from slambench import run

ROOT = os.path.dirname(run.HERE)


def _run(cwd, *args):
    env = dict(os.environ, PYTHONPATH=cwd)
    return subprocess.run([sys.executable, "-m", "slambench.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_means_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present here")
    p = _run(ROOT, "--workload", "bm-drive", "--seed", "5000000000",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_benchmark_alone_is_no_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(str(tmp_path), "--workload", "bm-drive", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_nothing_loaded_is_jax_or_the_jax_package():
    code = (
        "import sys, runpy\n"
        "import slambench.run, slambench.harness, slambench.stream, "
        "slambench.check, slambench.trace, slambench.control\n"
        "from slambench.reference import frontend\n"
        "import tpuslam_torch.runtime.fast_pipeline, "
        "tpuslam_torch.mapping.mapper, tpuslam_torch.geometry.camera, "
        "tpuslam_torch.io.native_loader, tpuslam_torch.vo.fused\n"
        "for kind in ('metrics', 'roofline'):\n"
        "    import os\n"
        "    for f in os.listdir(os.path.join(slambench.run.HERE, kind)):\n"
        "        if f.endswith('.py'):\n"
        "            slambench.run.load_module(kind, f[:-3])\n"
        "print(','.join(slambench.run.foreign_modules()))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == ""
    assert "tpuslam_torch" not in run.FORBIDDEN


def test_foreign_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpuslam_torch_fake", sys)
    assert "tpuslam_torch_fake" not in run.foreign_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.foreign_modules()
