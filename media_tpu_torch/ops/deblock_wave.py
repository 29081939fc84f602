"""Whole-frame H.264 deblocking wavefront: the CUDA kernel and its plain twin.

Replaces media_tpu/ops/deblock_wave_pallas.py:deblock_wavemajor_pallas, the
TPU kernel that runs the entire skewed MB wavefront of in-loop deblocking
(spec 8.7) in one launch. Both versions here compute the same function of
raster-order inputs: the planes, filtered in place, given a per-MB meta
tensor (see ops/deblock.py:META_COLS) that the caller builds from the bS
grids and the per-edge thresholds (pipeline/deblock_apply.py:build_meta).

MB (r, c) filters its own 16x16 block plus the 4 columns of its left
neighbour and the 4 rows of its top neighbour, all vertical edges first,
then all horizontal edges (chroma likewise). So (r, c) depends on (r, c-1),
(r-1, c) and (r-1, c+1), and the MBs of one wave k = 2r + c are independent:
their working patches are disjoint. The 2R+C-2 waves (254 at 1080p) must run
in order.

What bounds the kernel on an H100 is that chain of dependent steps, not
bytes or arithmetic: a 1080p frame is 3 MB and the filter math is a few
hundred operations per sample line. The design (csrc/deblock_wave.cu) is a
dataflow wavefront: one thread block per MB row, all rows in flight, each
walking its row left to right with its working patches in shared memory.
Row r may filter MB c once row r-1 has finished MB c+1 (its last MB: the
whole row). Row r-1 does not store its last sample rows to the planes: it
hands them to row r through a mailbox in device memory whose 8-byte slots
carry 4 samples and a tag, stored and polled as one word past L1, so the
hand-over needs no fence and no flag, and row r stores those rows once it has
filtered them. The MB's own samples and its meta row depend on nothing and
are prefetched. A grid larger than the device holds at once is serialised
over persistent blocks (row r waits only for row r-1, so rows taken in
ascending order cannot deadlock). The mailbox is scratch that this module
keeps per device, stream and geometry; the kernel leaves it zero.

`run_waves` is the other route over the same wavefront: one in-place launch
of the wave-step kernel (ops/deblock_pallas.py) per wave, replayed on CUDA
as one CUDA graph per geometry.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .deblock import META_COLS, check_aligned, check_planes as _check
from .deblock_pallas import (
    deblock_wave_step, deblock_wave_step_inplace_plain,
    launch_wave_step_inplace, n_waves, wave_mbs)

__all__ = ["deblock_wave", "deblock_wave_plain", "launch_deblock_wave",
           "n_waves", "run_waves", "wave_mbs"]


class _WaveGraph:
    """The wave steps of one (R, C) picture as one CUDA graph on planes and
    a meta tensor of its own."""

    def __init__(self, R: int, C: int, device: torch.device):
        from .. import kernels

        kernels.load()  # a build must not fall into the capture
        self.planes = [torch.zeros((R * s, C * s), dtype=torch.uint8,
                                   device=device) for s in (16, 8, 8)]
        self.meta = torch.zeros((R * C, META_COLS), dtype=torch.int32,
                                device=device)
        self.n = 0  # kernel nodes in the graph
        with torch.cuda.device(device):
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                for k in range(n_waves(R, C)):
                    self.n += launch_wave_step_inplace(*self.planes, self.meta,
                                                       R, C, k)

    def run(self, y, u, v, meta) -> None:
        for dst, src in zip((*self.planes, self.meta), (y, u, v, meta)):
            dst.copy_(src)
        self.graph.replay()
        for dst, src in zip((y, u, v), self.planes):
            dst.copy_(src)
        deblock_wave_step.launches += self.n  # the kernel nodes replayed


@functools.lru_cache(maxsize=8)
def _wave_graph(R: int, C: int, device: torch.device) -> _WaveGraph:
    return _WaveGraph(R, C, device)


def run_waves(y, u, v, meta, R: int, C: int) -> None:
    """Filter the uint8 planes y (16R, 16C) and u/v (8R, 8C) in place, one
    in-place wave step (ops/deblock_pallas.py) per wave, in order. On CUDA
    the launches of a picture are captured once per geometry and device as
    a CUDA graph and replayed (copy in, one replay, copy out; each replayed
    kernel counts in `deblock_wave_step.launches`), which takes a third of
    the time of launching them one by one on an H100. On the CPU each step
    is the plain version."""
    _check(y, u, v, meta, R, C)
    if y.device.type == "cpu":
        deblock_wave_plain(y, u, v, meta, R, C)
    else:
        _wave_graph(R, C, y.device).run(y, u, v, meta)


def deblock_wave_plain(y, u, v, meta, R: int, C: int) -> None:
    """Plain PyTorch version: filters the uint8 planes in place, one
    vectorised plain wave step per wave, on the tensors' device."""
    for k in range(n_waves(R, C)):
        deblock_wave_step_inplace_plain(y, u, v, meta, R, C, k)


@functools.lru_cache(maxsize=8)
def _mailbox(device: torch.device, stream: int, R: int, C: int):
    """The kernel's mailbox between MB rows, 24 slots of 8 bytes per MB: zero
    at the first launch, and the kernel leaves it zero. One per stream, so
    that launches on two streams do not share slots."""
    return torch.zeros(24 * R * C, dtype=torch.int64, device=device)


def launch_deblock_wave(y, u, v, meta, R: int, C: int, with_filter: bool = True,
                        max_blocks: int = 0) -> None:
    """Launch the whole-frame kernel on the current stream: no check, no
    count. with_filter=False runs the kernel's hand-overs, loads and stores
    without its edge filters (the floor its dependent chain sets);
    max_blocks > 0 caps the grid, so that fewer persistent blocks share the
    rows."""
    from .. import kernels

    ptr = ctypes.c_void_p
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = kernels.load().deblock_wave_launch(
        ptr(y.data_ptr()), ptr(u.data_ptr()), ptr(v.data_ptr()),
        ptr(meta.data_ptr()), ptr(_mailbox(y.device, stream, R, C).data_ptr()),
        ctypes.c_int(R), ctypes.c_int(C), ctypes.c_int(with_filter),
        ctypes.c_int(max_blocks), ptr(stream))
    if err:
        raise RuntimeError(f"deblock_wave kernel launch failed: "
                           f"{kernels.error_string(err)}")


def deblock_wave(y, u, v, meta, R: int, C: int) -> None:
    """Deblock a whole frame in place. On a CUDA tensor this launches the
    kernel (csrc/deblock_wave.cu) on the current stream and counts the
    launch in `deblock_wave.launches`; on a CPU tensor it runs the plain
    version."""
    _check(y, u, v, meta, R, C)
    if y.device.type == "cpu":
        deblock_wave_plain(y, u, v, meta, R, C)
        return
    check_aligned(y, u, v, meta)
    launch_deblock_wave(y, u, v, meta, R, C)
    deblock_wave.launches += 1


deblock_wave.launches = 0
