"""On the card: a short window of bm-drive at its full size comes out
correct.  Run there with

    python -m pytest -p no:cacheprovider slambench/tests/test_slambench_card.py
"""

from __future__ import annotations

import time

import pytest
import torch

from slambench import harness, run

pytestmark = pytest.mark.cuda


def test_bm_drive_short_window_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    spec = run.resolve(run.load_json(run.HERE, "..", "BENCHMARK.json"),
                       "bm-drive")
    t = time.perf_counter()
    res = harness.run(spec, 6_000_000_001, 8.0, False, t)
    assert res["correct"], res["checks"]
    assert res["metrics"]["stream_fps"]["value"] > 0
