"""The result line a run prints, and the runs that must print none."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from h264_bench import harness
from h264_bench.tests.conftest import ROOT


def check_line(out: dict, trace: bool) -> None:
    keys = list(out)
    assert keys[:3] == ["correct", "attempted", "failed"]
    assert keys[-1] == "compared"
    assert isinstance(out["correct"], bool)
    assert isinstance(out["attempted"], int) and out["attempted"] > 0
    assert isinstance(out["failed"], int)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float) or isinstance(m["value"], int)
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for k in ("device_ops", "idle_gaps"):
            assert len(out["breakdown"][k]) <= 10
            for name, seconds in out["breakdown"][k]:
                assert isinstance(name, str) and seconds >= 0
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(out))


@pytest.mark.parametrize("cell", ["tiny.natural", "tiny.screen"])
def test_untraced_line(tiny, cell):
    spec, bench = tiny
    out = harness.run_cell(spec, cell, 2**31 + 5, 0.0, False, device="cpu",
                           bench=bench)
    check_line(out, trace=False)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"encode_fps.natural", "setup_s"}
    assert out["metrics"]["encode_fps.natural"]["value"] > 0


def test_traced_line(tiny):
    spec, bench = tiny
    out = harness.run_cell(spec, "tiny.natural", 9, 0.0, True, device="cpu",
                           bench=bench)
    check_line(out, trace=True)
    assert out["correct"] is True
    # Without a device trace, the readers of device time find nothing.
    assert "device_idle.natural" not in out["metrics"]
    assert out["metrics"]["idr_ms.natural"]["value"] > 0


def run_py(cwd: str):
    return subprocess.run(
        [sys.executable, "h264_bench/run.py", "--workload",
         "h264_2160p_cqp.natural", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_cuda_no_result():
    res = run_py(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_bare_checkout_no_result(tmp_path):
    """A folder with BENCHMARK.json and h264_bench/ alone: no program."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "h264_bench"),
                    tmp_path / "h264_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = run_py(str(tmp_path))
    assert res.returncode != 0 and res.stdout.strip() == ""
