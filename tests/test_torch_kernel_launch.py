"""Every hand-kernel wrapper launches with its tensors' device current.

The kernels size their grids for, and launch on, the current CUDA device,
so each wrapper must enter `torch.cuda.device(<its tensors' device>)`
around the launch: a caller on another current device must not send the
kernel elsewhere. Here, with no card, the launches go to a stand-in for the
kernel library that records the device current at each call, the device
context is a recorder, and the tensors live on the "meta" device (a device
that is not the CPU, with shapes and no data); the card test is in
tests/test_torch_cuda.py.
"""

import contextlib
import types

import pytest
import torch

from media_tpu_torch import kernels
from media_tpu_torch.ops import deblock_pallas as tdp
from media_tpu_torch.ops import deblock_wave as tdw
from media_tpu_torch.ops.deblock import META_COLS

R, C = 3, 4


@pytest.fixture
def launches(monkeypatch):
    """The (entry point, device current at the call) of every launch."""
    current = [torch.device("cuda", 7)]  # what the caller had made current
    log = []

    @contextlib.contextmanager
    def device(dev):
        prev, current[0] = current[0], torch.device(dev)
        try:
            yield
        finally:
            current[0] = prev

    def entry(name):
        def launch(*args):
            log.append((name, current[0]))
            return 0
        return launch

    lib = types.SimpleNamespace(**{name: entry(name) for name in (
        "deblock_wave_launch", "deblock_wave_step_launch",
        "deblock_wave_step_inplace_launch")})
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(tdw.deblock_wave, "launches", 0)
    monkeypatch.setattr(tdp.deblock_wave_step, "launches", 0)
    return log


def _planes():
    meta = torch.device("meta")
    return (torch.empty((16 * R, 16 * C), dtype=torch.uint8, device=meta),
            torch.empty((8 * R, 8 * C), dtype=torch.uint8, device=meta),
            torch.empty((8 * R, 8 * C), dtype=torch.uint8, device=meta),
            torch.empty((R * C, META_COLS), dtype=torch.int32, device=meta))


def test_whole_frame_kernel_enters_its_tensors_device(launches):
    y, u, v, meta = _planes()
    tdw.deblock_wave(y, u, v, meta, R, C)
    tdw.launch_deblock_wave(y, u, v, meta, R, C, with_filter=False)
    assert launches == [("deblock_wave_launch", y.device)] * 2
    assert tdw.deblock_wave.launches == 1  # the raw launch is not counted


def test_wave_step_entries_enter_their_tensors_device(launches):
    y, u, v, meta = _planes()
    tdp.deblock_wave_step_inplace(y, u, v, meta, R, C, 2)
    assert tdp.launch_wave_step_inplace(y, u, v, meta, R, C, 3) == 1
    n = 5
    patches = [torch.empty((n, s, s), dtype=torch.uint8, device=y.device)
               for s in (20, 12, 12)]
    out = tdp.deblock_wave_step(*patches, torch.empty(
        (n, META_COLS), dtype=torch.int32, device=y.device))
    assert all(o.device == y.device for o in out)
    assert launches == [("deblock_wave_step_inplace_launch", y.device)] * 2 + [
        ("deblock_wave_step_launch", y.device)]
    assert tdp.deblock_wave_step.launches == 2
