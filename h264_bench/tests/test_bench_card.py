"""Each cell's run on the card with a short window: the last line parses
and `correct` holds. Marked `cuda`; skips where torch sees no card
(run with: python -m pytest h264_bench/tests -m cuda on the card's host)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from h264_bench.tests.conftest import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


@pytest.mark.parametrize("cell", ["h264_2160p_cqp.natural"])
def test_cell_on_the_card(card, cell):
    res = subprocess.run(
        [sys.executable, "h264_bench/run.py", "--workload", cell, "--seed",
         "2147483650", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
