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

What bounds the kernel on an H100 is the latency of that dependent wave
chain, not bytes or arithmetic: a 1080p frame is 3 MB and the filter math is
a few hundred operations per sample line. The design
(csrc/deblock_wave.cu): one persistent thread block walks the waves in order
and indexes MB (r, c) of wave k directly in the raster planes (no wave-major
shear, which existed for the TPU's DMA); one thread filters one line (row or
column) of one MB for all four edges, so only two __syncthreads() separate
the phases of a wave; the frame stays in L2. Reads at c = 0 / r = 0 are
guarded (bS is 0 there). That uses one SM of 132. Later work should measure
a cooperative grid with a grid-wide barrier per wave, and one launch per
wave captured in a CUDA graph, against it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .deblock import META_COLS
from .deblock_pallas import deblock_wave_step_plain


def n_waves(R: int, C: int) -> int:
    return 2 * (R - 1) + C


def wave_mbs(k: int, R: int, C: int, device):
    """(r, c) long tensors of the MBs in wave k = 2r + c, r ascending."""
    lo = max(0, -(-(k - C + 1) // 2))
    hi = min(R - 1, k // 2)
    r = torch.arange(lo, hi + 1, device=device)
    return r, k - 2 * r


@functools.lru_cache(maxsize=8)
def wave_patch_indices(R: int, C: int, device: torch.device):
    """Per wave: the (rows, cols) index pairs of its MBs' 20x20 luma and
    12x12 chroma patches in planes padded by 4 at the top and left, and the
    MBs' rows of the meta tensor. Built once per geometry and device."""
    ar20 = torch.arange(20, device=device)
    ar12 = torch.arange(12, device=device)
    out = []
    for k in range(n_waves(R, C)):
        r, c = wave_mbs(k, R, C, device)
        out.append(((r[:, None] * 16 + ar20)[:, :, None],
                    (c[:, None] * 16 + ar20)[:, None, :],
                    (r[:, None] * 8 + ar12)[:, :, None],
                    (c[:, None] * 8 + ar12)[:, None, :], r * C + c))
    return out


def pad_top_left(plane):
    """The plane with 4 rows and columns of zeros at the top and left, so
    that the MBs of row 0 and column 0 have patches too. Border edges have
    bS 0, so the padding is never filtered against."""
    out = torch.zeros((plane.shape[0] + 4, plane.shape[1] + 4),
                      dtype=plane.dtype, device=plane.device)
    out[4:, 4:] = plane
    return out


def run_waves(y, u, v, meta, R: int, C: int, step) -> None:
    """Filter the uint8 planes y (16R, 16C) and u/v (8R, 8C) in place, one
    call of `step(yp, up, vp, meta_rows)` per wave: a gather of the patches
    of the wave's MBs, the step, a scatter back. Only MBs that exist are
    gathered, and their patches are disjoint, so no scatter index repeats."""
    yp, up, vp = (pad_top_left(p) for p in (y, u, v))
    for ry, cy, rc, cc, rows in wave_patch_indices(R, C, y.device):
        yp[ry, cy], up[rc, cc], vp[rc, cc] = step(
            yp[ry, cy], up[rc, cc], vp[rc, cc], meta[rows])
    y.copy_(yp[4:, 4:])
    u.copy_(up[4:, 4:])
    v.copy_(vp[4:, 4:])


def deblock_wave_plain(y, u, v, meta, R: int, C: int) -> None:
    """Plain PyTorch version: filters the uint8 planes in place, one
    vectorised plain wave step per wave."""
    run_waves(y, u, v, meta, R, C, deblock_wave_step_plain)


def _check(y, u, v, meta, R: int, C: int) -> None:
    for name, p, size in (("y", y, 16), ("u", u, 8), ("v", v, 8)):
        if p.dtype != torch.uint8 or p.shape != (R * size, C * size):
            raise ValueError(f"{name}: expected uint8 ({R * size}, "
                             f"{C * size}), got {p.dtype} {tuple(p.shape)}")
        if not p.is_contiguous() or p.device != y.device:
            raise ValueError(f"{name}: must be contiguous on {y.device}")
    if (meta.dtype != torch.int32 or meta.shape != (R * C, META_COLS)
            or not meta.is_contiguous() or meta.device != y.device):
        raise ValueError(f"meta: expected contiguous int32 ({R * C}, "
                         f"{META_COLS}) on {y.device}")


def deblock_wave(y, u, v, meta, R: int, C: int) -> None:
    """Deblock a whole frame in place. On a CUDA tensor this launches the
    kernel (csrc/deblock_wave.cu) on the current stream and counts the
    launch in `deblock_wave.launches`; on a CPU tensor it runs the plain
    version."""
    _check(y, u, v, meta, R, C)
    if y.device.type == "cpu":
        deblock_wave_plain(y, u, v, meta, R, C)
        return
    from .. import kernels

    lib = kernels.load()
    err = lib.deblock_wave_launch(
        ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(u.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(meta.data_ptr()),
        ctypes.c_int(R), ctypes.c_int(C),
        ctypes.c_void_p(torch.cuda.current_stream(y.device).cuda_stream))
    if err:
        raise RuntimeError(f"deblock_wave kernel launch failed: "
                           f"{kernels.error_string(err)}")
    deblock_wave.launches += 1


deblock_wave.launches = 0
